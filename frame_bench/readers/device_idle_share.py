"""100 * (1 - union of the device's busy intervals / host-clock length
of the traced window of frames)."""


def read(ctx, **_):
    tr = ctx["trace"]
    if tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
