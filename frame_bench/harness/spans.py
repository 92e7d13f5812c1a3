"""The program's host spans of its last frames, from the span store of
prosper_tpu_torch (utils/profiler.py `gprofiler`), which records each
frame's spans while a torch.profiler session runs: the traced window.

A frame is a list of span records {"name", "kind", "start_ns", "end_ns",
"parent"}: kind "frame" (the mode's frame call), "pass" (a render
pass), "wait" (a call that blocks the host on the device) or "host";
parent is the index of the enclosing span in the frame's list, or -1.
`last_frames` gives nothing where the program keeps no such store or
has recorded fewer frames than asked for, and the readers then report
nothing.
"""

from __future__ import annotations


def last_frames(n: int) -> list[list[dict]] | None:
    """The span records of the program's last n frames, oldest first."""
    try:
        from prosper_tpu_torch.utils.profiler import gprofiler
    except ImportError:
        return None
    frames = getattr(gprofiler, "frames", None)
    if n <= 0 or not callable(frames):
        return None
    got = frames(n)
    if len(got) < n:
        return None
    return [[{"name": s.name, "kind": s.kind, "start_ns": s.start_ns,
              "end_ns": s.end_ns, "parent": s.parent} for s in f.spans]
            for f in got]


def frame_ns(frame: list[dict]) -> int | None:
    """The duration of the frame's outermost frame span."""
    outer = [s for s in frame if s["kind"] == "frame" and s["parent"] < 0]
    return outer[0]["end_ns"] - outer[0]["start_ns"] if outer else None


def waits(frame: list[dict]) -> list[dict]:
    return [s for s in frame if s["kind"] == "wait"]


def self_ns(frame: list[dict], name: str, kind: str = "pass") -> int | None:
    """Self time of the frame's spans of that name and kind: their
    durations less the parts their child spans cover; None where the
    frame has no such span."""
    mine = [i for i, s in enumerate(frame)
            if s["name"] == name and s["kind"] == kind]
    if not mine:
        return None
    total = sum(frame[i]["end_ns"] - frame[i]["start_ns"] for i in mine)
    keep = set(mine)
    return total - sum(s["end_ns"] - s["start_ns"] for s in frame
                       if s["parent"] in keep)


def window_frames(ctx) -> list[list[dict]] | None:
    """The span records of the traced window's frames."""
    return last_frames(int(ctx["window"]["frames"]))
