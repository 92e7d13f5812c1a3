"""Host seconds from the generated inputs to the scene's tensors on the
device: cluster boxes, the BVH build, the light rows, the upload and the
trace slabs (the program's scene path)."""


def read(ctx, **_):
    return ctx["scene_setup_s"]
