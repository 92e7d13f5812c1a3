"""The Plücker ray-triangle block, plain PyTorch.

Counterpart of experiments/trace_plucker.py: `plucker_rows_from_slab`
(:42) turns a (9, 128) v0 | e1 | e2 slab into PLU_ROWS feature rows, and
`plucker_block_plain` is `_plucker_block` (:73): per edge e = (P, Q),
side_e = [d | o x d] . [P x Q | Q - P], so the pairwise work is two
(R, 6) @ (6, 128) products (edges AB and CA) and two (R, 3) @ (3, 128)
plane products (n.d and n.o), then a short epilogue:

    u = s_CA / den, v = s_AB / den, t = (n.v0 - n.o) / den,
    hit: |den| > 1e-9, u, v >= 0, u + v <= 1, t_min < t < t_upper.

On the TPU the products ran on the MXU; on the card they run on the
tensor cores (csrc/bench_kernels.cu, mma.sync TF32). tf32=True rounds
the products' operands to TF32 as the card's cvt.rna.tf32.f32 does
(round to nearest, ties away from zero, 10 mantissa bits), the plain
version of the tensor-core block; the sums stay float32, in order.
`tf32_agreement` holds a tensor-core block's t to that plain version.
"""

from __future__ import annotations

import torch

PLU_ROWS = 22  # packed feature rows (experiments/trace_plucker.py:35)
PLU_DET_EPS = 1e-9
# row blocks of the four products: (first row, K)
SIDE_AB, SIDE_CA, NORMAL = (0, 6), (12, 6), (18, 3)
C_ROW = 21  # n . v0


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def plucker_rows_from_slab(slab: torch.Tensor) -> torch.Tensor:
    """(9, 128) v0 | e1 | e2 slab -> (PLU_ROWS, 128) feature rows:
    0:6 [g_AB | u_AB], 6:12 [g_BC | u_BC], 12:18 [g_CA | u_CA], 18:21
    n = e1 x e2, 21 c = n . v0 (experiments/trace_plucker.py:29-34)."""
    v0x, v0y, v0z = slab[0], slab[1], slab[2]
    e1x, e1y, e1z = slab[3], slab[4], slab[5]
    e2x, e2y, e2z = slab[6], slab[7], slab[8]
    v0e1 = _cross(v0x, v0y, v0z, e1x, e1y, e1z)
    v0e2 = _cross(v0x, v0y, v0z, e2x, e2y, e2z)
    n = _cross(e1x, e1y, e1z, e2x, e2y, e2z)
    g2 = tuple(v0e2[i] - v0e1[i] + n[i] for i in range(3))
    c = n[0] * v0x + n[1] * v0y + n[2] * v0z
    return torch.stack([
        v0e1[0], v0e1[1], v0e1[2], e1x, e1y, e1z,
        g2[0], g2[1], g2[2], e2x - e1x, e2y - e1y, e2z - e1z,
        -v0e2[0], -v0e2[1], -v0e2[2], -e2x, -e2y, -e2z,
        n[0], n[1], n[2],
        c,
    ])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as cvt.rna.tf32.f32; inf stays inf."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, rows, block, tf32):
    """a (R, >=K) @ rows[first:first+K] as a float32 sum over k in
    order, each term's operands rounded to TF32 when tf32."""
    first, k = block
    b = rows[first:first + k]
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    out = a[:, 0:1] * b[0]
    for i in range(1, k):
        out = out + a[:, i:i + 1] * b[i]
    return out


def _ray_lhs(o, d):
    """[d | o x d] (R, 6), the left operand of the side products."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    return torch.cat([dx, dy, dz, mx, my, mz], dim=1)


def plucker_terms(rows, o, d, tf32: bool = False):
    """(R, 128) raw terms of rays o, d (R, 3) against one PLU_ROWS x 128
    feature slab -> (den, t, u, v), with t, u, v 0 where |den| <=
    PLU_DET_EPS. `_plucker_block`'s arithmetic, in its order."""
    lhs = _ray_lhs(o, d)
    s1 = _product(lhs, rows, SIDE_AB, tf32)
    s3 = _product(lhs, rows, SIDE_CA, tf32)
    den = _product(d, rows, NORMAL, tf32)
    o_n = _product(o, rows, NORMAL, tf32)
    ok = torch.abs(den) > PLU_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)
    return den, (rows[C_ROW] - o_n) * inv, s3 * inv, s1 * inv


def plucker_block_plain(rows, o, d, t_min, t_upper, tf32: bool = False):
    """(R, 128) intersection of rays o, d (R, 3) with one PLU_ROWS x 128
    feature slab -> (hit, t, u, v), t = inf where missed; t_upper scalar
    or (R, 1)."""
    den, t, u, v = plucker_terms(rows, o, d, tf32)
    hit = ((torch.abs(den) > PLU_DET_EPS) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > t_min) & (t < t_upper))
    return hit, torch.where(hit, t, float("inf")), u, v


# Two sums of the same six exact TF32 products (a product of two TF32
# values fits float32's mantissa) in different orders, or with the
# tensor cores' own rounding, differ by at most a few float32 ulps of
# the sum of the terms' magnitudes; SUM_ERR bounds that difference
# (2 x 5 additions of at most 2^-23 relative error each, rounded up).
SUM_ERR = 32 * 2.0 ** -24
BORDER = 1e-6  # beyond the sums' bound: the epilogue's own rounding
T_RTOL = 1e-5


def tf32_agreement(rows, o, d, t_min, t_upper, t, border: float = BORDER,
                   rtol: float = T_RTOL):
    """A tensor-core Plücker block's t (R, 128), inf on a miss, against
    the TF32 plain block of rays o, d (R, 3) at the same t_min and t_upper
    -> {"hits": the plain block's, "kernel_hits", "union": pairs either
    hits, "border": pairs of the union on the border, "mismatches":
    pairs off the border where the two disagree on the hit,
    "union_agreement": share of the union both hit, "t_rel_err": max
    relative t error where both hit, "t_err_ratio": max of |t - t_plain|
    over rtol |t_plain| + the sums' bound on t, where both hit}.

    The tensor cores sum the TF32 products in their own order, so u, v,
    den and t may move by the sums' bound (SUM_ERR x the sum of the terms'
    magnitudes, over |den|) and a pair may flip only where the plain
    block's u, v or 1 - u - v lies within `border` plus that bound of 0,
    its t as near t_min or t_upper (border relative to max(1, |t|)), or
    |den| as near the determinant threshold: the border. Off it the hit
    must agree, and where both hit t within rtol plus the bound."""
    den, tp, u, v = plucker_terms(rows, o, d, tf32=True)
    hit_p = ((torch.abs(den) > PLU_DET_EPS) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (tp > t_min) & (tp < t_upper))
    hit_k = torch.isfinite(t)
    lhs, absrows = _ray_lhs(o, d).abs(), rows.abs()
    mag_den = _product(d.abs(), absrows, NORMAL, True)
    inv = 1.0 / torch.clamp_min(torch.abs(den), PLU_DET_EPS)
    err_u = SUM_ERR * (_product(lhs, absrows, SIDE_CA, True)
                       + u.abs() * mag_den) * inv
    err_v = SUM_ERR * (_product(lhs, absrows, SIDE_AB, True)
                       + v.abs() * mag_den) * inv
    err_t = SUM_ERR * (_product(o.abs(), absrows, NORMAL, True)
                       + tp.abs() * mag_den) * inv
    near_t = border * torch.clamp_min(tp.abs(), 1.0) + err_t
    on_border = ((u.abs() < border + err_u) | (v.abs() < border + err_v)
                 | ((1.0 - u - v).abs() < border + err_u + err_v)
                 | ((tp - t_min).abs() < near_t)
                 | ((tp - t_upper).abs() < near_t)
                 | (torch.abs(den) <= 2 * PLU_DET_EPS + SUM_ERR * mag_den))
    union = hit_p | hit_k
    both = hit_p & hit_k
    diff = torch.where(both, (t - tp).abs(), 0.0)
    rel = diff / torch.clamp_min(tp.abs(), 1e-6)
    ratio = diff / (rtol * tp.abs() + err_t)
    n_union = int(union.sum())
    return {"hits": int(hit_p.sum()), "kernel_hits": int(hit_k.sum()),
            "union": n_union, "border": int((union & on_border).sum()),
            "mismatches": int((union & ~both & ~on_border).sum()),
            "union_agreement": int(both.sum()) / max(n_union, 1),
            "t_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "t_err_ratio": float(ratio.max()) if ratio.numel() else 0.0}
