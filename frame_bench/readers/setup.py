"""Seconds from the process's start to the first timed frame: imports,
the device, the kernels' build or load, the inputs, the scene path and
the warm-up frames."""


def read(ctx, **_):
    return ctx["setup_s"]
