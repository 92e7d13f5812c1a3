"""Meshlet building (numpy): the port's analog of upstream's
meshoptimizer pipeline (DeferredLoadingContext.cpp:340-440: optimize ->
meshlets of at most 64 vertices and 124 triangles, cone_weight 0.5; the
limits are the reference's src/utils/Utils.hpp:18-19).

Clusters serve double duty:
1. They are the culling granularity of the meshlet draw-list pipeline
   (frustum/cone/HiZ tests over flat cluster arrays, SURVEY.md §7).
2. They are the BVH leaf granularity of ray traversal: a leaf visit
   tests a cluster's 128-slot triangle tile.

Instead of meshoptimizer's vertex-cache optimisation (a rasteriser's
concern), the partition is spatial, top-down, which is what culling and
BVH quality need (`cluster_ranges`):
- first the aligned-SAH ranges of `sah_cluster_ranges` (every cluster
  full but one); a mesh whose ranges all hold at most 64 distinct
  vertices keeps them, as the JAX package's builder makes them;
- else `meshlet_ranges`, which keeps every cluster within both limits
  and fills clusters about as a 64-vertex grid patch allows (7x7 quads,
  98 triangles), so a mesh's clusters are then no longer all full.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Parity with the reference limits (Utils.hpp:18-19); storage pads to 128.
MAX_MESHLET_VERTICES = 64
MAX_MESHLET_TRIANGLES = 124
CLUSTER_TRI_PAD = 128
# meshlet_ranges: a node that may fit in this many clusters is sliced
# along one axis; above it, a split's sides are estimated at this many
# new vertices a cluster (the rest are repeated on the clusters' borders)
SLICE_MAX = 4
VERTS_PER_CLUSTER = 58


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z into 30-bit Morton codes (uint32)."""

    def expand(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint32) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(x) << 2) | (expand(y) << 1) | expand(z)


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort order of points along a Morton curve."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    codes = morton3d(q[:, 0], q[:, 1], q[:, 2])
    return np.argsort(codes, kind="stable")


@dataclass
class MeshClusters:
    """Cluster (meshlet) table for one mesh primitive.

    Triangles are stored re-ordered so each cluster's triangles are
    contiguous; `tri_vidx` indexes the primitive's vertex list.
    """

    tri_vidx: np.ndarray  # (T, 3) u32, in cluster order
    cluster_offset: np.ndarray  # (C,) u32 first-tri index
    cluster_count: np.ndarray  # (C,) u32 tri count (<= MAX_MESHLET_TRIANGLES)
    # each cluster's triangles name <= MAX_MESHLET_VERTICES distinct vertices
    aabb_min: np.ndarray  # (C, 3) f32 object space
    aabb_max: np.ndarray  # (C, 3) f32
    cone_apex: np.ndarray  # (C, 3) f32 (bounding sphere center)
    cone_axis: np.ndarray  # (C, 3) f32 average facet normal
    cone_cutoff: np.ndarray  # (C,) f32 cos(angle)+safety, like meshopt cones
    sphere_radius: np.ndarray  # (C,) f32


def _half_area(d: np.ndarray) -> np.ndarray:
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def sah_cluster_ranges(
    v: np.ndarray, tris: np.ndarray, max_tris: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-down ALIGNED-SAH triangle partition into max_tris clusters.

    Returns (order, offsets, counts): `order` permutes triangles so each
    cluster's triangles are contiguous, clusters listed left-to-right.

    Replaces the Morton-curve + fixed-stride chunking: Morton runs cross
    surface discontinuities, producing elongated overlapping cluster
    AABBs — the round-2 profile measured incoherent bounce packets
    union-visiting ~92 cluster leaves while each ray needs ~11. Each
    node sorts its triangles along each axis and evaluates the EXACT SAH
    cost at every max_tris-ALIGNED cut position, picking the best
    (axis, cut): cluster count stays exactly ceil(T / max_tris) with
    every cluster full except one, and full 124-triangle leaves keep the
    traversal kernels' Möller density, while cluster bounds become
    near-SAH-optimal. The ranges ignore vertex counts: `cluster_ranges`
    keeps them only where each holds at most 64 distinct vertices.
    """
    T = len(tris)
    p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    cent = ((p0 + p1 + p2) / 3.0).astype(np.float32)
    tmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)

    order = np.arange(T)
    ranges: list[tuple[int, int]] = []
    stack = [(0, T)]
    while stack:
        s, e = stack.pop()
        count = e - s
        if count <= max_tris:
            ranges.append((s, e))
            continue
        idx = order[s:e]
        c = cent[idx]
        # aligned candidate cuts keep the left side a multiple of
        # max_tris, so every cluster left of any cut fills completely
        cuts = np.arange(max_tris, count, max_tris)
        best = None  # (cost, axis, perm-by-axis, mid)
        for axis in range(3):
            srt = np.argsort(c[:, axis], kind="stable")
            mn = tmin[idx][srt]
            mx = tmax[idx][srt]
            # prefix/suffix bounds -> exact SAH at each aligned cut
            lmn = np.minimum.accumulate(mn, axis=0)[cuts - 1]
            lmx = np.maximum.accumulate(mx, axis=0)[cuts - 1]
            rmn = np.minimum.accumulate(mn[::-1], axis=0)[::-1][cuts]
            rmx = np.maximum.accumulate(mx[::-1], axis=0)[::-1][cuts]
            cost = _half_area(np.maximum(lmx - lmn, 0.0)) * cuts + _half_area(
                np.maximum(rmx - rmn, 0.0)
            ) * (count - cuts)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, srt, int(cuts[k]))
        _, _, srt, mid = best
        order[s:e] = idx[srt]
        stack.append((s + mid, e))
        stack.append((s, s + mid))
    ranges.sort()
    offsets = np.array([s for s, _ in ranges], np.uint32)
    counts = np.array([e - s for s, e in ranges], np.uint32)
    return order, offsets, counts


def cluster_vertex_counts(tris: np.ndarray, offsets: np.ndarray,
                          counts: np.ndarray) -> np.ndarray:
    """(C,) distinct vertices of each cluster of triangles `tris` (T, 3),
    cluster c holding rows [offsets[c], offsets[c] + counts[c])."""
    C = len(offsets)
    if C == 0:
        return np.zeros(0, np.int64)
    counts = np.asarray(counts, np.int64)
    cid = np.repeat(np.arange(C), counts)
    rows = np.repeat(np.asarray(offsets, np.int64) - np.cumsum(counts) + counts,
                     counts) + np.arange(len(cid))
    v = np.asarray(tris, np.int64)[rows]
    span = int(v.max(initial=0)) + 1
    return np.bincount(np.unique(cid[:, None] * span + v) // span, minlength=C)


def _repeats(flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each position of `flat`, the position of the same value before
    it and after it, -1 where there is none."""
    o = np.argsort(flat, kind="stable")
    same = flat[o][1:] == flat[o][:-1]
    prev = np.full(len(flat), -1, np.int64)
    nxt = np.full(len(flat), -1, np.int64)
    prev[o[1:][same]] = o[:-1][same]
    nxt[o[:-1][same]] = o[1:][same]
    return prev, nxt


def _distinct_prefix_suffix(sub: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For a run of n triangles (n, 3): (n + 1,) distinct vertices of the
    first i triangles, and (n + 1,) of the triangles from i on."""
    prev, nxt = _repeats(sub.reshape(-1))
    firsts = (prev < 0).reshape(-1, 3).sum(1)
    lasts = (nxt < 0).reshape(-1, 3).sum(1)
    return (np.concatenate([[0], np.cumsum(firsts)]),
            np.concatenate([np.cumsum(lasts[::-1])[::-1], [0]]))


def _greedy_slices(sub: np.ndarray, k_max: int, max_tris: int,
                   max_verts: int) -> list[int] | None:
    """Cuts of a triangle run (n, 3) into its longest runs within both
    limits, front to back: the fewest contiguous pieces (a piece's
    distinct vertices only grow with its length). None past k_max
    pieces."""
    n = len(sub)
    prev, _ = _repeats(sub.reshape(-1))
    cuts = [0]
    while cuts[-1] < n:
        if len(cuts) > k_max:
            return None
        p = cuts[-1]
        hi = min(n, p + max_tris)
        # distinct vertices of [p, p + m) for m = 1 .. hi - p
        seen = np.cumsum(prev[3 * p:3 * hi] < 3 * p)[2::3]
        cuts.append(p + max(int(np.searchsorted(seen, max_verts, "right")), 1))
    return cuts


def meshlet_ranges(
    v: np.ndarray,
    tris: np.ndarray,
    max_tris: int = MAX_MESHLET_TRIANGLES,
    max_verts: int = MAX_MESHLET_VERTICES,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A top-down partition whose every cluster holds at most max_tris
    triangles and max_verts distinct vertices; (order, offsets, counts)
    as sah_cluster_ranges gives them.

    A node within both limits is a cluster. Each other node sorts its
    triangles along each axis by centroid (stable) and:
    - where it may fit in SLICE_MAX clusters (its triangles over
      max_tris and its vertices over max_verts, rounded up, at most
      SLICE_MAX), is cut along the axis that gives the fewest greedy
      slices (`_greedy_slices`, at most SLICE_MAX; ties: the smaller
      summed SAH cost), each slice a cluster;
    - else is cut in two, each side keeping at least an eighth of the
      triangles, where the clusters the two sides need, by the estimate
      max(ceil(triangles / max_tris), ceil(vertices /
      VERTS_PER_CLUSTER)), add up least; ties: the smaller SAH cost.
    VERTS_PER_CLUSTER stands below max_verts for the vertices that the
    borders between clusters repeat. The eighth keeps the depth
    logarithmic: where a cut through the middle repeats many vertices (a
    cloud of separate plates), the estimate alone would peel one small
    piece off at a time. A 64x64-quad grid averages 85 triangles a
    cluster; 7x7-quad patches, the densest that 64 vertices of a grid
    allow, hold 98. Deterministic: stable sorts and no randomness."""
    T = len(tris)
    p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    cent = ((p0 + p1 + p2) / 3.0).astype(np.float32)
    tmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)

    order = np.arange(T)
    ranges: list[tuple[int, int]] = []
    stack = [(0, T)]
    while stack:
        s, e = stack.pop()
        n = e - s
        idx = order[s:e]
        sub = tris[idx]
        nv = len(np.unique(sub))
        if n <= max_tris and nv <= max_verts:
            ranges.append((s, e))
            continue
        sorts = [np.argsort(cent[idx, axis], kind="stable") for axis in range(3)]
        if max(-(-n // max_tris), -(-nv // max_verts)) <= SLICE_MAX:
            best = None  # ((pieces, cost), axis, cuts)
            for axis, srt in enumerate(sorts):
                cuts = _greedy_slices(sub[srt], SLICE_MAX, max_tris, max_verts)
                if cuts is None:
                    continue
                mn, mx = tmin[idx][srt], tmax[idx][srt]
                cost = sum(float(_half_area(mx[a:b].max(0) - mn[a:b].min(0)))
                           * (b - a) for a, b in zip(cuts[:-1], cuts[1:]))
                if best is None or (len(cuts), cost) < best[0]:
                    best = ((len(cuts), cost), axis, cuts)
            if best is not None:
                _, axis, cuts = best
                order[s:e] = idx[sorts[axis]]
                ranges.extend((s + a, s + b) for a, b in zip(cuts[:-1], cuts[1:]))
                continue
        # cuts in the middle three quarters: every split sheds an eighth
        cut = np.arange(max(1, n // 8), n - n // 8)
        best = None  # ((clusters, cost), axis, mid)
        for axis, srt in enumerate(sorts):
            mn, mx = tmin[idx][srt], tmax[idx][srt]
            lmn = np.minimum.accumulate(mn, axis=0)[cut - 1]
            lmx = np.maximum.accumulate(mx, axis=0)[cut - 1]
            rmn = np.minimum.accumulate(mn[::-1], axis=0)[::-1][cut]
            rmx = np.maximum.accumulate(mx[::-1], axis=0)[::-1][cut]
            cost = _half_area(np.maximum(lmx - lmn, 0.0)) * cut + _half_area(
                np.maximum(rmx - rmn, 0.0)) * (n - cut)
            pre, suf = _distinct_prefix_suffix(sub[srt])
            need = (np.maximum(-(-cut // max_tris),
                               -(-pre[cut] // VERTS_PER_CLUSTER))
                    + np.maximum(-(-(n - cut) // max_tris),
                                 -(-suf[cut] // VERTS_PER_CLUSTER)))
            k = int(np.argmin(np.where(need == need.min(), cost, np.inf)))
            key = (int(need[k]), float(cost[k]))
            if best is None or key < best[0]:
                best = (key, axis, int(cut[k]))
        _, axis, mid = best
        order[s:e] = idx[sorts[axis]]
        stack.append((s + mid, e))
        stack.append((s, s + mid))
    ranges.sort()
    offsets = np.array([s for s, _ in ranges], np.uint32)
    counts = np.array([e - s for s, e in ranges], np.uint32)
    return order, offsets, counts


def cluster_ranges(
    v: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mesh's partition into meshlets, (order, offsets, counts): the
    aligned-SAH ranges where each holds at most 64 distinct vertices (the
    JAX package's partition, bit for bit), else meshlet_ranges. World
    lays its arenas out from these counts, a streamed mesh's placeholder
    included."""
    v = np.asarray(v, np.float32)
    tris = np.asarray(tris).reshape(-1, 3).astype(np.uint32)
    order, offsets, counts = sah_cluster_ranges(v, tris, MAX_MESHLET_TRIANGLES)
    if cluster_vertex_counts(tris[order], offsets, counts).max(
            initial=0) <= MAX_MESHLET_VERTICES:
        return order, offsets, counts
    return meshlet_ranges(v, tris)


def build_clusters(
    positions: np.ndarray,
    indices: np.ndarray,
    ranges: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
) -> MeshClusters:
    """Cluster a triangle mesh into meshlets of at most 124 triangles and
    64 distinct vertices.

    The partition is cluster_ranges' (or `ranges`, its result for this
    mesh); per-cluster bounds come from the native C++ pipeline
    (cpp/asset_pipeline.cpp) when built, numpy otherwise, by one rule:
    the box's centre, the farthest vertex from it, the normalised sum of
    the facet normals and the cutoff sqrt(1 - min_dot^2)."""
    from . import native

    tris = indices.reshape(-1, 3).astype(np.uint32)
    v = positions.astype(np.float32)
    if ranges is None:
        ranges = cluster_ranges(v, tris)
    order, offsets, counts = ranges
    tris = tris[order]

    if native.available():
        bounds = native.cluster_bounds(v, tris, offsets, counts)
        aabb_min, aabb_max, center, radius, axis, cutoff = bounds
        return MeshClusters(
            tri_vidx=tris,
            cluster_offset=offsets,
            cluster_count=counts,
            aabb_min=aabb_min,
            aabb_max=aabb_max,
            cone_apex=center,
            cone_axis=axis,
            cone_cutoff=cutoff,
            sphere_radius=radius,
        )

    p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]

    n_clusters = len(offsets)
    aabb_min = np.empty((n_clusters, 3), np.float32)
    aabb_max = np.empty((n_clusters, 3), np.float32)
    cone_apex = np.empty((n_clusters, 3), np.float32)
    cone_axis = np.empty((n_clusters, 3), np.float32)
    cone_cutoff = np.empty(n_clusters, np.float32)
    sphere_radius = np.empty(n_clusters, np.float32)

    # facet normals (unnormalised = area weighted)
    fn = np.cross(p1 - p0, p2 - p0)
    fn_len = np.linalg.norm(fn, axis=1, keepdims=True)
    fn_unit = fn / np.maximum(fn_len, 1e-20)

    for c in range(n_clusters):
        s, e = offsets[c], offsets[c] + counts[c]
        pts = np.concatenate([p0[s:e], p1[s:e], p2[s:e]], axis=0)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        aabb_min[c], aabb_max[c] = mn, mx
        center = (mn + mx) * 0.5
        cone_apex[c] = center
        sphere_radius[c] = float(np.linalg.norm(pts - center, axis=1).max())
        axis = fn[s:e].sum(axis=0)
        alen = np.linalg.norm(axis)
        if alen < 1e-12:
            cone_axis[c] = np.array([0, 0, 1], np.float32)
            cone_cutoff[c] = 1.0  # degenerate: never cone-cull
            continue
        axis = axis / alen
        cone_axis[c] = axis
        # Cutoff = cos of max deviation between axis and any facet normal;
        # cutoff >= 1 disables culling (meshopt convention: cull when
        # dot(view, axis) >= cutoff never holds).
        min_dot = float(np.dot(fn_unit[s:e], axis).min())
        if min_dot <= 0.0:
            cone_cutoff[c] = 1.0
        else:
            # cos(a+90deg) margin like meshopt: sqrt(1-mindot^2) bound
            cone_cutoff[c] = float(np.sqrt(1.0 - min_dot * min_dot))

    return MeshClusters(
        tri_vidx=tris,
        cluster_offset=offsets,
        cluster_count=counts,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        cone_apex=cone_apex,
        cone_axis=cone_axis,
        cone_cutoff=cone_cutoff,
        sphere_radius=sphere_radius,
    )
