"""Reduction of a torch.profiler trace of a window of frames.

The device rows (kernels, copies and sets; not the record_function
ranges that the profiler copies onto the device timeline), the union of
their intervals, the device time by outermost pass scope (the
arithmetic of prosper_tpu_torch/utils/profiler.py `pass_table` as it
stood at commit e89c417, copied here), the top device operations, and
the idle gaps named by the host operation running at their middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# the render modules' pass scopes (utils/profiler.py PASS_SCOPES)
PASS_SCOPES = (
    "primary_trace", "wavefront", "accumulate", "gbuffer",
    "light_clustering", "shading", "skybox", "transparent", "bloom",
    "particles", "taa", "dof", "tonemap", "ris_initial", "spatial_shade",
)
OTHER = "(other)"


def _is_annotation(e) -> bool:
    return getattr(e, "is_user_annotation", False) or e.name in PASS_SCOPES


def device_rows(events) -> list:
    """Every operation on the CUDA device: kernels, copies and sets."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not _is_annotation(e)]


def _outer_pass(e) -> str:
    name = OTHER
    while e is not None:
        if e.name in PASS_SCOPES:
            name = e.name
        e = e.cpu_parent
    return name


def _is_launch(e) -> bool:
    return e.name.startswith(("cuda", "cuLaunch"))


def pass_ms(events, rows, frames: int) -> dict:
    """{pass: device ms a frame}: each kernel's device time counts for
    the outermost pass scope around the runtime call that launched it."""
    from torch.autograd import DeviceType

    launches = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and _is_launch(e)}
    per = defaultdict(float)
    for k in rows:
        if k.name.startswith(("Memcpy", "Memset")):
            continue
        per[_outer_pass(launches.get(k.id))] += (
            k.time_range.end - k.time_range.start) / 1e3
    return {p: ms / max(frames, 1) for p, ms in per.items()}


def busy_intervals(rows) -> list:
    """The union of the rows' [start, end) in us, merged and sorted."""
    spans = sorted((r.time_range.start, r.time_range.end) for r in rows)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def top_ops(rows, n: int = 10) -> list:
    tot = defaultdict(float)
    for r in rows:
        tot[r.name] += (r.time_range.end - r.time_range.start) / 1e6
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def idle_gaps(events, merged, n: int = 10, longest: int = 400) -> list:
    """[[host operation, idle seconds]]: the `longest` gaps between busy
    intervals, each named by the innermost host operation at its middle
    (its outermost pass scope first), summed by name."""
    from torch.autograd import DeviceType

    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:longest]
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and not getattr(e, "is_async", False)),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in cpu]
    tot = defaultdict(float)
    for length, a, b in gaps:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        # the innermost operation open at mid among the nearest 2000
        for e in cpu[max(0, i - 2000):i]:
            if e.time_range.end >= mid and (
                    best is None or e.time_range.start >= best.time_range.start):
                best = e
        name = "(no host operation)" if best is None else (
            f"{_outer_pass(best)}/{best.name}")
        tot[name] += length / 1e6
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def reduce(events, frames: int, window_s: float) -> dict:
    """The trace's numbers that the readers and the result line take."""
    rows = device_rows(events)
    merged = busy_intervals(rows)
    busy_us = sum(e - s for s, e in merged)
    return {
        "rows": rows,
        "frames": frames,
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "pass_ms": pass_ms(events, rows, frames),
        "breakdown": {"device_ops": top_ops(rows),
                      "idle_gaps": idle_gaps(events, merged)},
    }
