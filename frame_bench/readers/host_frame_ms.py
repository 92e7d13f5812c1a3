"""The host's dispatch time a frame: mean over the traced window of the
program's frame span less its wait spans, in ms (host clock, under
torch.profiler)."""

from frame_bench.harness import spans


def read(ctx, **_):
    frames = spans.window_frames(ctx)
    if not frames:
        return None
    per = []
    for f in frames:
        total = spans.frame_ns(f)
        if total is None:
            return None
        per.append(total - sum(s["end_ns"] - s["start_ns"]
                               for s in spans.waits(f)))
    return sum(per) / len(per) / 1e6
