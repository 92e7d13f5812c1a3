"""Share of the scene's meshlets that culling kept from being drawn over
the window's frames: 100 * (1 - drawn / (frames * all meshlets)), from
the frame call's own count of drawn meshlets and the number of clusters
of the program's scene (a glTF scene's World clusters)."""


def read(ctx, **_):
    stats, n_all = ctx["stats"], int(ctx["n_clusters"])
    if not stats or n_all <= 0:
        return None
    return 100.0 * (1.0 - sum(stats) / (len(stats) * n_all))
