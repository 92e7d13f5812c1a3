"""Device ms a frame of one render pass scope (the outermost pass scope
around each kernel's launch). Nothing where no kernel ran in it."""


def read(ctx, scope, **_):
    return ctx["trace"]["pass_ms"].get(scope)
