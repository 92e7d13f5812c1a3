"""Temporal anti-aliasing resolve.

Counterpart of prosper_tpu/ops/taa.py (`min_max_clip`, `variance_clip`,
`closest_velocity`, `largest_velocity`, `_bilinear`, `catmull_rom`,
`taa_resolve`), taa_resolve.comp of the reference with the defaults of
TemporalAntiAliasing.hpp:81-84: variance clipping, closest velocity,
Catmull-Rom history, luminance weighting. Images are (H, W, C) tensors.
"""

from __future__ import annotations

import torch

from ..mathx.color import luminance


def edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Pad the first two axes by r with their edge values (jnp.pad
    mode="edge")."""
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(-r, h + r, device=img.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-r, w + r, device=img.device), 0, w - 1)
    return img[ys][:, xs]


def shifts_3x3(img: torch.Tensor) -> torch.Tensor:
    """The 9 edge-padded shifted copies, (9, H, W, ...), row by row."""
    padded = edge_pad(img, 1)
    h, w = img.shape[:2]
    return torch.stack([padded[dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)])


def min_max_clip(illum: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    n = shifts_3x3(illum)
    return torch.clamp(prev, n.amin(dim=0), n.amax(dim=0))


def variance_clip(illum: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    n = shifts_3x3(illum)
    m1 = n.sum(dim=0) / 9.0
    m2 = (n * n).sum(dim=0) / 9.0
    sigma = torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0))
    return torch.clamp(prev, m1 - sigma, m1 + sigma)


def _take(v: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """v (9, H, W, C) at the neighbour best (H, W) of each pixel."""
    idx = best[None, ..., None].expand(1, *best.shape, v.shape[-1])
    return torch.gather(v, 0, idx)[0]


def closest_velocity(velocity: torch.Tensor,
                     depth: torch.Tensor) -> torch.Tensor:
    """The velocity of the 3x3 neighbour with the largest reverse-z
    depth (the first such neighbour on ties)."""
    d = shifts_3x3(depth[..., None])[..., 0]
    return _take(shifts_3x3(velocity), torch.argmax(d, dim=0))


def largest_velocity(velocity: torch.Tensor) -> torch.Tensor:
    v = shifts_3x3(velocity)
    return _take(v, torch.argmax((v * v).sum(-1), dim=0))


def bilinear_clamped(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with clamp-to-edge; uv (..., 2) in [0, 1]."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def g(yi, xi):
        yi = torch.clamp(yi.to(torch.int32), 0, h - 1).long()
        xi = torch.clamp(xi.to(torch.int32), 0, w - 1).long()
        return img[yi, xi]

    return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x0 + 1) * fx * (1 - fy)
            + g(y0 + 1, x0) * (1 - fx) * fy + g(y0 + 1, x0 + 1) * fx * fy)


def catmull_rom(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Jimenez's optimized 5-tap Catmull-Rom (taa_resolve.comp:90-127)."""
    h, w = img.shape[:2]
    res = torch.tensor([float(w), float(h)], dtype=torch.float32,
                       device=img.device)
    inv_res = 1.0 / res
    position = uv * res
    center = torch.floor(position - 0.5) + 0.5
    f = position - center
    f2 = f * f
    f3 = f * f2
    c = 0.7
    w0 = -c * f3 + 2.0 * c * f2 - c * f
    w1 = (2.0 - c) * f3 - (3.0 - c) * f2 + 1.0
    w2 = -(2.0 - c) * f3 + (3.0 - 2.0 * c) * f2 + c * f
    w3 = c * f3 - c * f2
    w12 = w1 + w2
    tc12 = inv_res * (center + w2 / w12)
    tc0 = inv_res * (center - 1.0)
    tc3 = inv_res * (center + 2.0)

    def tap(u, v, weight):
        col = bilinear_clamped(img, torch.stack([u, v], dim=-1))
        return torch.cat([col, torch.ones_like(col[..., :1])],
                         -1) * weight[..., None]

    acc = tap(tc12[..., 0], tc12[..., 1], w12[..., 0] * w12[..., 1])
    acc = acc + tap(tc12[..., 0], tc0[..., 1], w12[..., 0] * w0[..., 1])
    acc = acc + tap(tc0[..., 0], tc12[..., 1], w0[..., 0] * w12[..., 1])
    acc = acc + tap(tc3[..., 0], tc12[..., 1], w3[..., 0] * w12[..., 1])
    acc = acc + tap(tc12[..., 0], tc3[..., 1], w12[..., 0] * w3[..., 1])
    return acc[..., :3] / acc[..., 3:4]


def taa_resolve(illumination: torch.Tensor, previous_resolved: torch.Tensor,
                velocity: torch.Tensor, depth: torch.Tensor,
                ignore_history: bool = False, use_catmull_rom: bool = True,
                color_clipping: str = "variance",
                velocity_sampling: str = "closest",
                luminance_weighting: bool = True) -> torch.Tensor:
    """Blend illumination (H, W, 3) with the reprojected history;
    velocity (H, W, 2), depth (H, W) reverse-z. color_clipping: none |
    minmax | variance; velocity_sampling: center | largest | closest."""
    if ignore_history:
        return illumination
    h, w = illumination.shape[:2]
    dev = illumination.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([gx, gy], dim=-1)

    if velocity_sampling == "center":
        vel = velocity
    elif velocity_sampling == "largest":
        vel = largest_velocity(velocity)
    else:
        vel = closest_velocity(velocity, depth)
    half = torch.tensor([0.5, -0.5], dtype=torch.float32, device=dev)
    reproj = uv - vel * half
    on_screen = ((reproj >= 0.0) & (reproj <= 1.0)).all(-1, keepdim=True)

    if use_catmull_rom:
        prev = catmull_rom(previous_resolved, reproj)
    else:
        prev = bilinear_clamped(previous_resolved, reproj)
    if color_clipping == "minmax":
        prev = min_max_clip(illumination, prev)
    elif color_clipping == "variance":
        prev = variance_clip(illumination, prev)

    current_weight = torch.full((h, w, 1), 0.1, dtype=torch.float32,
                                device=dev)
    history_weight = 1.0 - current_weight
    if luminance_weighting:
        current_weight = current_weight * (
            1.0 / (1.0 + luminance(illumination))[..., None])
        history_weight = history_weight * (
            1.0 / (1.0 + luminance(prev))[..., None])
    resolved = (illumination * current_weight + prev * history_weight) / (
        torch.clamp_min(current_weight + history_weight, 1e-5))
    return torch.where(on_screen, resolved, illumination)
