"""ms a frame the host spends blocked on the device: mean over the
traced window of the time inside the program's wait spans."""

from frame_bench.harness import spans


def read(ctx, **_):
    frames = spans.window_frames(ctx)
    if not frames or any(spans.frame_ns(f) is None for f in frames):
        return None
    return sum(s["end_ns"] - s["start_ns"] for f in frames
               for s in spans.waits(f)) / len(frames) / 1e6
