"""Ray casting against the scene's triangles, in plain PyTorch.

The triangles come in groups of 128 (one plate, one cluster slab of the
inputs); each group's box is worked out from its corners. A block of rays
is tested against every group's box, the groups a ray enters are sorted
by entry distance, and the rays then test the 128 triangles of their
k-th group in rounds (Möller-Trumbore, both faces) until no ray has a
group left that could hold a nearer hit (closest hit) or every ray has
found one (any hit). A hit lies strictly between t_min and t_max.
"""

from __future__ import annotations

import torch

GROUP = 128


class Triangles:
    """The scene's triangles on a device: v0, e1, e2 as (G, 128, 3) and
    each group's box (G, 3) x 2."""

    def __init__(self, p0, p1, p2, device):
        p0, p1, p2 = (torch.as_tensor(p, dtype=torch.float32, device=device)
                      for p in (p0, p1, p2))
        G = p0.shape[0] // GROUP
        self.v0 = p0.reshape(G, GROUP, 3)
        self.e1 = (p1 - p0).reshape(G, GROUP, 3)
        self.e2 = (p2 - p0).reshape(G, GROUP, 3)
        corners = torch.stack([p0, p1, p2], 1).reshape(G, GROUP * 3, 3)
        self.lo = corners.amin(1)
        self.hi = corners.amax(1)
        self.device = torch.device(device)

    def chunk(self) -> int:
        return 32768 if self.device.type == "cuda" else 2048


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _group_hits(tris: Triangles, g, o, d):
    """(t, u, v, hit) of rays o, d (A, 3) against the 128 triangles of
    group g (A,) each: (A, 128)."""
    v0, e1, e2 = tris.v0[g], tris.e1[g], tris.e2[g]
    o, d = o[:, None, :], d[:, None, :]
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv = 1.0 / torch.where(det != 0, det, 1.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
    return t, u, v, hit


def _entries(tris: Triangles, o, d, t_min, t_max):
    """Groups sorted by the distance at which each ray enters their box:
    (sorted entry distances, group ids, count of boxes entered)."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    near = far = None
    for ax in range(3):
        a = (tris.lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        b = (tris.hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    ok = ((near <= far) & (far > t_min) & (near < t_max[:, None])
          & (t_max > t_min)[:, None])
    key = torch.where(ok, near, float("inf"))
    keys, groups = torch.sort(key, dim=1)
    return keys, groups, ok.sum(1)


def trace(tris: Triangles, o, d, t_min: float, t_max, any_hit: bool):
    """Rays o, d (R, 3) float32; t_max (R,) -> closest hit (t, tri, u,
    v) per ray (t = t_max, tri = -1 without one), or with any_hit the
    (R,) bool occlusion."""
    R = o.shape[0]
    dev = o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(R).contiguous()
    out_t = t_max.clone()
    out_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(R, dtype=torch.float32, device=dev)
    out_v = torch.zeros(R, dtype=torch.float32, device=dev)
    step = tris.chunk()
    for r0 in range(0, R, step):
        sl = slice(r0, min(R, r0 + step))
        oo, dd, best = o[sl], d[sl], out_t[sl].clone()
        tri = torch.full_like(out_tri[sl], -1)
        uu, vv = torch.zeros_like(best), torch.zeros_like(best)
        keys, groups, n = _entries(tris, oo, dd, t_min, best)
        for j in range(int(n.max()) if n.numel() else 0):
            act = (n > j) & (keys[:, j] < best)
            if any_hit:
                act &= tri < 0
            idx = act.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            g = groups[idx, j]
            t, u, v, hit = _group_hits(tris, g, oo[idx], dd[idx])
            ok = hit & (t > t_min) & (t < best[idx, None])
            t = torch.where(ok, t, float("inf"))
            tbest, lane = t.min(1)
            better = tbest < best[idx]
            idx, lane = idx[better], lane[better]
            best[idx] = tbest[better]
            tri[idx] = g[better] * GROUP + lane
            rows = better.nonzero().squeeze(1)
            uu[idx] = u[rows, lane]
            vv[idx] = v[rows, lane]
        out_t[sl], out_tri[sl], out_u[sl], out_v[sl] = best, tri, uu, vv
    if any_hit:
        return out_tri >= 0
    return out_t, out_tri, out_u, out_v
