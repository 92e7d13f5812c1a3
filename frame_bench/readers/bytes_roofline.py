"""Share of the bytes bound in the device time of the trace kernels:
100 * sum over the recorded calls of (bytes their rays, results and
triangles need / peak bytes per second) / sum of those kernels' device seconds.

The calls are those of the wrappers that the cell's trace-call table
patches; a kernel symbol whose launches in the trace do not match its
recorded calls one for one makes the reading nothing, as does a window
without such a kernel."""

import re
from collections import Counter


def read(ctx, peak_bytes_per_s, **_):
    calls = ctx["trace_calls"]
    if not calls:
        return None
    want = Counter(k for k, _, _ in calls)
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, want))
                     + r")(?![A-Za-z0-9_])")
    got, secs = Counter(), 0.0
    for r in ctx["trace"]["rows"]:
        m = pat.search(r.name)
        if m:
            got[m.group(1)] += 1
            secs += (r.time_range.end - r.time_range.start) / 1e6
    if got != want or secs <= 0:
        return None
    bound = sum(b for _, _, b in calls) / float(peak_bytes_per_s)
    return 100.0 * bound / secs
