"""The host's self time a frame in one render pass scope: mean over the
traced window of the pass span's duration less its child spans (its
waits among them), in ms. Nothing where no frame opened the pass."""

from frame_bench.harness import spans


def read(ctx, scope, **_):
    frames = spans.window_frames(ctx)
    if not frames:
        return None
    per = [spans.self_ns(f, scope) for f in frames]
    if all(ns is None for ns in per):
        return None
    return sum(ns or 0 for ns in per) / len(per) / 1e6
