"""A copy of prosper_tpu/scene/meshlets.py (numpy), kept in the port so that it
imports nothing of the JAX package.

Meshlet/cluster building: the TPU analog of the reference's meshoptimizer
pipeline (DeferredLoadingContext.cpp:340-440: optimize -> meshlets 64v/124t,
cone_weight 0.5; limits the reference's src/utils/Utils.hpp:18-19).

Design note (TPU-first): clusters serve double duty here.
1. They are the culling granularity for the meshlet draw-list pipeline
   (frustum/cone/HiZ tests over flat cluster arrays, SURVEY.md §7).
2. They are the BVH leaf granularity for ray traversal: a leaf visit
   intersects the whole 128-padded triangle tile against a ray packet with
   dense VPU math — irregular per-triangle gathers become regular tiles.

Instead of meshoptimizer's vertex-cache optimisation (a HW-rasteriser
concern), we order triangles along a Morton curve of their centroids so
clusters are spatially tight, which is what both culling and BVH quality
actually need on TPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Parity with the reference limits (Utils.hpp:18-19); storage pads to 128.
MAX_MESHLET_VERTICES = 64
MAX_MESHLET_TRIANGLES = 124
CLUSTER_TRI_PAD = 128


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

    tri_vidx: np.ndarray  # (T, 3) u32, Morton-reordered
    cluster_offset: np.ndarray  # (C,) u32 first-tri index
    cluster_count: np.ndarray  # (C,) u32 tri count (<= MAX_MESHLET_TRIANGLES)
    aabb_min: np.ndarray  # (C, 3) f32 object space
    aabb_max: np.ndarray  # (C, 3) f32
    cone_apex: np.ndarray  # (C, 3) f32 (bounding sphere center)
    cone_axis: np.ndarray  # (C, 3) f32 average facet normal
    cone_cutoff: np.ndarray  # (C,) f32 cos(angle)+safety, like meshopt cones
    sphere_radius: np.ndarray  # (C,) f32


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
    every cluster full except one — the streaming placeholders and slot
    arenas keep their layout, and full 124-triangle leaves keep the
    traversal kernels' Möller density — while cluster bounds become
    near-SAH-optimal.
    """
    T = len(tris)
    p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    cent = ((p0 + p1 + p2) / 3.0).astype(np.float32)
    tmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)

    def half_area(d):
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

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
            cost = half_area(np.maximum(lmx - lmn, 0.0)) * cuts + half_area(
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


def build_clusters(
    positions: np.ndarray,
    indices: np.ndarray,
    max_tris: int = MAX_MESHLET_TRIANGLES,
) -> MeshClusters:
    """Cluster a triangle mesh into spatially-coherent meshlets.

    Triangle partition is binned-SAH (sah_cluster_ranges); per-cluster
    bounds come from the native C++ pipeline (cpp/asset_pipeline.cpp)
    when built, numpy otherwise."""
    from . import native

    tris = indices.reshape(-1, 3).astype(np.uint32)
    v = positions.astype(np.float32)

    if native.available():
        order, offsets, counts = sah_cluster_ranges(v, tris, max_tris)
        tris = tris[order]
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

    order, offsets, counts = sah_cluster_ranges(v, tris, max_tris)
    tris = tris[order]
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
