"""Ray-primitive intersection math.

Counterpart of prosper_tpu/ops/intersect.py `moller_trumbore`, written
operation for operation as the Pallas block `trace_pallas._moller_block`
(trace_pallas.py:76-116) and as the CUDA kernels in csrc/trace_bvh.cu
and csrc/trace_flat.cu, so the plain tracers and the kernels round
alike. No backface culling. Also `packet_aabb_enter_exit` (:55-96), the
ray-packet cull of the flat tracers, written as csrc/trace_flat.cu
`packet_enter_exit` evaluates it, and `packet_aabb_overlap_2d` (:152),
the leaf-major tracer's tile cull.
"""

from __future__ import annotations

import torch

DET_EPS = 1e-10


def moller_trumbore(o, d, v0, e1, e2, t_min, t_upper):
    """Batched Möller-Trumbore. o, d, v0, e1, e2: (..., 3), broadcast
    against each other; t_min, t_upper broadcast against the result.

    Returns (hit, t, u, v); a hit needs |det| > 1e-10, u, v >= 0,
    u + v <= 1 and t_min < t < t_upper."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    v0x, v0y, v0z = v0[..., 0], v0[..., 1], v0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (
        ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_upper)
    )
    return hit, t, u, v


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Slab-test reciprocal: 1/d, or 1e30 where |d| <= 1e-12
    (trace_bvh.py:118)."""
    return torch.where(
        torch.abs(d) > 1e-12, 1.0 / torch.where(d == 0.0, 1.0, d), 1e30
    )


def slab_enter_exit(o, inv_d, bmin, bmax):
    """Per-ray slab test of AABBs, the BVH node test of
    trace_bvh.py:229-255: enter = max(tx_min, ty_min, max(tz_min, 0)),
    exit = min of the far planes. o, inv_d: (..., 3); bmin, bmax
    broadcast against them. Returns (enter, exit)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    enter = torch.maximum(
        torch.maximum(tn[..., 0], tn[..., 1]),
        torch.clamp_min(tn[..., 2], 0.0),
    )
    exit_ = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
    return enter, exit_


BIG = 3e38  # the entry / exit of a box no packet overlaps


def packet_aabb_enter_exit(o_lo, o_hi, d_lo, d_hi, bmin, bmax):
    """Conservative interval-arithmetic slab entry and exit distances of
    a ray packet (origins in [o_lo, o_hi], directions in [d_lo, d_hi],
    (..., 3) each) against AABBs broadcast against them. An axis whose
    direction interval holds 0 does not restrict. An inverted box (some
    bmin > bmax: a masked-out cluster, render/gbuffer._masked_aabbs)
    gets enter = 3e38 > exit = -3e38: the min / max of the interval
    products would otherwise turn it into a box holding everything.
    Returns (enter, exit)."""
    uniform = (d_lo > 0.0) | (d_hi < 0.0)
    inv_a = torch.where(uniform, 1.0 / torch.where(uniform, d_hi, 1.0), 0.0)
    inv_b = torch.where(uniform, 1.0 / torch.where(uniform, d_lo, 1.0), 0.0)
    lo0, hi0 = bmin - o_hi, bmin - o_lo
    lo1, hi1 = bmax - o_hi, bmax - o_lo

    def imul_min(alo, ahi):
        return torch.minimum(torch.minimum(alo * inv_a, alo * inv_b),
                             torch.minimum(ahi * inv_a, ahi * inv_b))

    def imul_max(alo, ahi):
        return torch.maximum(torch.maximum(alo * inv_a, alo * inv_b),
                             torch.maximum(ahi * inv_a, ahi * inv_b))

    enter_ax = torch.where(
        uniform, torch.minimum(imul_min(lo0, hi0), imul_min(lo1, hi1)), -BIG)
    exit_ax = torch.where(
        uniform, torch.maximum(imul_max(lo0, hi0), imul_max(lo1, hi1)), BIG)
    enter = torch.maximum(torch.maximum(enter_ax[..., 0], enter_ax[..., 1]),
                          enter_ax[..., 2])
    exit_ = torch.minimum(torch.minimum(exit_ax[..., 0], exit_ax[..., 1]),
                          exit_ax[..., 2])
    invalid = (bmin > bmax).any(dim=-1)
    return (torch.where(invalid, BIG, enter),
            torch.where(invalid, -BIG, exit_))


def packet_aabb_overlap_2d(o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_max):
    """The (packets x AABBs) packet cull of ops/trace_leafmajor
    candidate_lists (prosper_tpu/ops/intersect.py:152-213), as written
    there: o_lo, o_hi, d_lo, d_hi (P, 3) packet bounds, bmin, bmax (A,
    3), t_max (P,) -> (P, A) bool. Per axis with uniform direction sign,
    the entry is the smaller and the exit the larger of the interval
    products at both slab planes; an axis whose direction interval
    holds 0 does not restrict. Overlap: every bmin <= bmax, enter <=
    exit, exit >= 0 and enter <= t_max. No t_min. This is not
    packet_aabb_enter_exit's test (that one drops inverted boxes by its
    entry, this one by the explicit valid term)."""
    P, A = o_lo.shape[0], bmin.shape[0]
    enter = torch.full((P, A), -BIG, dtype=torch.float32, device=o_lo.device)
    exit_ = torch.full((P, A), BIG, dtype=torch.float32, device=o_lo.device)
    for ax in range(3):
        dlo, dhi = d_lo[:, ax:ax + 1], d_hi[:, ax:ax + 1]
        olo, ohi = o_lo[:, ax:ax + 1], o_hi[:, ax:ax + 1]
        bmn, bmx = bmin[None, :, ax], bmax[None, :, ax]
        uniform = (dlo > 0.0) | (dhi < 0.0)
        inv_a = torch.where(uniform, 1.0 / torch.where(uniform, dhi, 1.0), 0.0)
        inv_b = torch.where(uniform, 1.0 / torch.where(uniform, dlo, 1.0), 0.0)
        lo0, hi0 = bmn - ohi, bmn - olo
        lo1, hi1 = bmx - ohi, bmx - olo

        def imul_min(alo, ahi):
            return torch.minimum(torch.minimum(alo * inv_a, alo * inv_b),
                                 torch.minimum(ahi * inv_a, ahi * inv_b))

        def imul_max(alo, ahi):
            return torch.maximum(torch.maximum(alo * inv_a, alo * inv_b),
                                 torch.maximum(ahi * inv_a, ahi * inv_b))

        en_ax = torch.minimum(imul_min(lo0, hi0), imul_min(lo1, hi1))
        ex_ax = torch.maximum(imul_max(lo0, hi0), imul_max(lo1, hi1))
        enter = torch.maximum(enter, torch.where(uniform, en_ax, -BIG))
        exit_ = torch.minimum(exit_, torch.where(uniform, ex_ax, BIG))
    valid = (bmin <= bmax).all(dim=-1)[None, :]
    return (valid & (enter <= exit_) & (exit_ >= 0.0)
            & (enter <= t_max[:, None]))
