"""Host-clock ms of the whole window over the frames completed in it."""


def read(ctx, **_):
    w = ctx["window"]
    return 1e3 * w["seconds"] / w["frames"] if w["frames"] else None
