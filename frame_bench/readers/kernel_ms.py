"""Device ms a frame in the kernels whose names hold one of `symbols` as
a whole word. Nothing where none ran."""

import re


def read(ctx, symbols, **_):
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, symbols))
                     + r")(?![A-Za-z0-9_])")
    tr = ctx["trace"]
    ms = [(r.time_range.end - r.time_range.start) / 1e3 for r in tr["rows"]
          if pat.search(r.name)]
    if not ms or not tr["frames"]:
        return None
    return sum(ms) / tr["frames"]
