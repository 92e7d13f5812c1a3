"""Device operations (kernels, copies, sets) a frame in the traced
window."""


def read(ctx, **_):
    tr = ctx["trace"]
    return len(tr["rows"]) / tr["frames"] if tr["rows"] and tr["frames"] else None
