"""BVH construction over cluster AABBs (host side, numpy).

A copy of prosper_tpu/accel/bvh.py `Bvh`, `build_bvh`, `_sah_split`,
`pack_nodes`, `pack_nodes8` and `transform_aabbs` (:31-289): binned-SAH
BVH2 over cluster AABBs, packed into the kernel-facing node arrays
bounds (N, 6) f32 [min | max] and meta (N, 3) i32 [left, right,
leaf_cluster (-1 internal)] that ops/trace_bvh.py walks, and into the
(N8, 8, 8) 8-wide table of its 8-wide kernels. The port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Bvh:
    nodes_min: np.ndarray
    nodes_max: np.ndarray
    nodes_left: np.ndarray
    nodes_right: np.ndarray
    nodes_first: np.ndarray
    nodes_count: np.ndarray
    order: np.ndarray  # (C,) input-index per reordered slot
    depth: int

    @property
    def n_nodes(self) -> int:
        return len(self.nodes_left)


def build_bvh(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    max_leaf_size: int = 4,
    sah: bool = True,
) -> Bvh:
    """Binned-SAH BVH2 (16 centroid bins per widest axis), median-split
    fallback when SAH finds no useful cut.

    SAH cuts the leaves visited by incoherent (bounce/shadow) packets
    ~1.5-2x vs a pure median split; the split recursion still bounds
    depth for the kernel's fixed SMEM stack (degenerate runs fall back
    to median/index splits).
    """
    n = len(aabb_min)
    assert n > 0
    cent = (aabb_min + aabb_max) * 0.5

    # Worst case nodes = 2*ceil(n/1) but with max_leaf_size leaves it's less;
    # allocate generously and trim.
    cap = max(2 * n, 16)
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    nodes_left = np.full(cap, -1, np.int32)
    nodes_right = np.full(cap, -1, np.int32)
    nodes_first = np.zeros(cap, np.int32)
    nodes_count = np.zeros(cap, np.int32)

    order = np.arange(n)
    n_nodes = 0
    max_depth = 0

    # iterative build: stack of (node_index, start, end, depth)
    def alloc() -> int:
        nonlocal n_nodes
        i = n_nodes
        n_nodes += 1
        return i

    root = alloc()
    stack = [(root, 0, n, 1)]
    while stack:
        node, s, e, depth = stack.pop()
        max_depth = max(max_depth, depth)
        idx = order[s:e]
        mn = aabb_min[idx].min(axis=0)
        mx = aabb_max[idx].max(axis=0)
        nodes_min[node] = mn
        nodes_max[node] = mx
        count = e - s
        if count <= max_leaf_size:
            nodes_first[node] = s
            nodes_count[node] = count
            continue
        c = cent[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        mid = count // 2
        if ext[axis] <= 1e-12:
            # all centroids identical (e.g. unstreamed degenerate
            # clusters): split by index — keeps leaves <= max_leaf_size
            # (traversal kernels require exactly one cluster per leaf)
            part = np.arange(count)
        else:
            part = None
            # depth guard: SAH cuts can be lopsided; the traversal
            # kernels carry a fixed-size SMEM stack, so force balanced
            # median splits past depth 32
            if sah and count > 2 and depth < 32:
                part, mid = _sah_split(
                    aabb_min[idx], aabb_max[idx], c, axis, ext
                )
                if part is not None:
                    mid = int(mid)
            if part is None:
                part = np.argpartition(c[:, axis], mid)
        order[s:e] = idx[part]
        left = alloc()
        right = alloc()
        nodes_left[node] = left
        nodes_right[node] = right
        stack.append((left, s, s + mid, depth + 1))
        stack.append((right, s + mid, e, depth + 1))

    return Bvh(
        nodes_min=nodes_min[:n_nodes].copy(),
        nodes_max=nodes_max[:n_nodes].copy(),
        nodes_left=nodes_left[:n_nodes].copy(),
        nodes_right=nodes_right[:n_nodes].copy(),
        nodes_first=nodes_first[:n_nodes].copy(),
        nodes_count=nodes_count[:n_nodes].copy(),
        order=order,
        depth=max_depth,
    )


_SAH_BINS = 16


def _sah_split(bmin, bmax, cent, axis, ext):
    """Binned SAH over the widest centroid axis. Returns (perm, mid) or
    (None, None) when no cut beats keeping the median (degenerate)."""
    lo = cent[:, axis].min()
    scale = _SAH_BINS * (1.0 - 1e-6) / max(ext[axis], 1e-20)
    bins = np.minimum(
        ((cent[:, axis] - lo) * scale).astype(np.int32), _SAH_BINS - 1
    )

    # per-bin bounds + counts
    counts = np.bincount(bins, minlength=_SAH_BINS)
    binf = np.full((_SAH_BINS, 3), 1e30, np.float32)
    binx = np.full((_SAH_BINS, 3), -1e30, np.float32)
    np.minimum.at(binf, bins, bmin)
    np.maximum.at(binx, bins, bmax)

    def growing_area(mn, mx, cnt):
        gmn = np.minimum.accumulate(mn, axis=0)
        gmx = np.maximum.accumulate(mx, axis=0)
        d = np.maximum(gmx - gmn, 0.0)
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        return np.where(np.cumsum(cnt) > 0, area, 0.0), np.cumsum(cnt)

    a_l, n_l = growing_area(binf, binx, counts)
    a_r, n_r = growing_area(binf[::-1], binx[::-1], counts[::-1])
    a_r, n_r = a_r[::-1], n_r[::-1]
    # cost of cutting after bin k (k in 0.._SAH_BINS-2)
    cost = a_l[:-1] * n_l[:-1] + a_r[1:] * n_r[1:]
    valid = (n_l[:-1] > 0) & (n_r[1:] > 0)
    if not valid.any():
        return None, None
    cost = np.where(valid, cost, np.inf)
    k = int(np.argmin(cost))
    left_mask = bins <= k
    mid = int(left_mask.sum())
    perm = np.argsort(~left_mask, kind="stable")
    return perm, mid


def pack_nodes(bvh: Bvh) -> tuple[np.ndarray, np.ndarray]:
    """Kernel-facing node arrays for ops/trace_bvh.py.

    Returns (bounds (N, 6) f32 [min.xyz | max.xyz],
             meta (N, 3) i32 [left, right, leaf_cluster(-1 internal)]).
    Requires max_leaf_size == 1 builds (one cluster per leaf).
    """
    assert bvh.nodes_count.max() <= 1, "pack_nodes requires max_leaf_size=1"
    bounds = np.concatenate([bvh.nodes_min, bvh.nodes_max], axis=1).astype(
        np.float32
    )
    cluster = np.where(
        bvh.nodes_count > 0, bvh.order[bvh.nodes_first], -1
    ).astype(np.int32)
    meta = np.stack([bvh.nodes_left, bvh.nodes_right, cluster], axis=1).astype(
        np.int32
    )
    return bounds, meta


def pack_nodes8(bvh: Bvh) -> np.ndarray:
    """Collapse a max_leaf_size=1 BVH2 into an 8-wide node table.

    Each 8-wide node is built by repeatedly expanding the largest-area
    internal slot of {node} until 8 slots are filled (the classic
    wide-BVH collapse). Returns (N8, 8, 8) f32: node n, child slot c holds
    [min.xyz | max.xyz | enc | 0] where enc >= 0 is an internal child's
    8-wide node index and enc < 0 encodes leaf cluster -(cluster+1).
    Empty slots carry NaN bounds and enc 0 (0 is the root, which no slot
    points at): a slab test written with min/max that return the non-NaN
    operand would let such a slot through, so the walks skip it by its
    NaN explicitly."""
    assert bvh.nodes_count.max() <= 1
    is_leaf = bvh.nodes_count > 0
    ext = np.maximum(bvh.nodes_max - bvh.nodes_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    blocks: list[np.ndarray] = []
    # each work item: (8-wide index, slot, BVH2 internal node to emit)
    patch: list[tuple[int, int, int]] = []

    def collect_slots(n2: int) -> list[int]:
        slots = [n2]
        while len(slots) < 8:
            best, best_a = -1, -1.0
            for si, s in enumerate(slots):
                if not is_leaf[s] and area[s] > best_a:
                    best_a, best = float(area[s]), si
            if best < 0:
                break
            s = slots.pop(best)
            slots.append(int(bvh.nodes_left[s]))
            slots.append(int(bvh.nodes_right[s]))
        return slots

    def emit(n2: int) -> int:
        my = len(blocks)
        blk = np.zeros((8, 8), np.float32)
        blk[:, 0:6] = np.nan
        blocks.append(blk)
        slots = [n2] if is_leaf[n2] else collect_slots(n2)
        for j, s in enumerate(slots):
            blk[j, 0:3] = bvh.nodes_min[s]
            blk[j, 3:6] = bvh.nodes_max[s]
            if is_leaf[s]:
                blk[j, 6] = -(float(bvh.order[bvh.nodes_first[s]]) + 1.0)
            else:
                patch.append((my, j, s))
        return my

    # iterative emission (the patch queue doubles as the work list)
    emit(0)
    qi = 0
    while qi < len(patch):
        my, j, s = patch[qi]
        qi += 1
        blocks[my][j, 6] = float(emit(s))
    return np.stack(blocks).astype(np.float32)


def nodes8_depth(nodes8: np.ndarray) -> int:
    """Levels of 8-wide nodes on the longest root-to-leaf path of a
    pack_nodes8 table (1 when the root's slots are all leaves). A walk
    that pushes every entered child holds at most 7 entries per level
    above the node it expands, plus that node's 8: 7 * depth + 1."""
    enc = nodes8[:, :, 6]
    real = ~np.isnan(nodes8[:, :, 0])
    depth, level = 0, [0]
    while level:
        depth += 1
        e = enc[level]
        level = e[real[level] & (e > 0)].astype(np.int64).tolist()
    return depth


def transform_aabbs(
    aabb_min: np.ndarray, aabb_max: np.ndarray, m: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Conservative AABB transform by a 4x4 (TLAS instance transform):
    the |R| trick, new_extent = |M3x3| @ extent."""
    c = (aabb_min + aabb_max) * 0.5
    e = (aabb_max - aabb_min) * 0.5
    r = m[:3, :3]
    new_c = c @ r.T + m[:3, 3]
    new_e = e @ np.abs(r).T
    return (new_c - new_e).astype(np.float32), (new_c + new_e).astype(np.float32)
