"""Share of the 128-slot triangle tiles of the program's scene that hold
a real triangle: 100 * the configuration's `triangles` (the scene's world
triangles, each instance counted) / (the program's clusters * 128). The
culled G-buffer (K4) and the cull walk every tile; a cluster of fewer
triangles leaves slots empty. Nothing for a configuration that does not
state its triangles."""


def read(ctx, **_):
    tris, n = ctx["config"].get("triangles"), int(ctx["n_clusters"])
    if tris is None or n <= 0:
        return None
    return 100.0 * float(tris) / (n * 128)
