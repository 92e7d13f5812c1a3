"""Host-device synchronisations a frame: the program's wait spans over
the traced window's frames."""

from frame_bench.harness import spans


def read(ctx, **_):
    frames = spans.window_frames(ctx)
    if not frames or any(spans.frame_ns(f) is None for f in frames):
        return None
    return sum(len(spans.waits(f)) for f in frames) / len(frames)
