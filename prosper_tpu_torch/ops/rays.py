"""Camera rays and the self-intersection offset.

Counterpart of prosper_tpu/ops/rays.py (`pinhole_rays`,
`thin_lens_rays`, `offset_ray`), ray.glsl:15-105 of the reference.
"""

from __future__ import annotations

import math

import torch


def pinhole_rays(cam: dict, uv: torch.Tensor):
    """uv: (..., 2) in [0, 1] (already jittered) -> (o, d)."""
    nd = uv * 2.0 - 1.0
    c2c = cam["camera_to_clip"]
    w2c = cam["world_to_camera"]
    aspect = c2c[1, 1] / c2c[0, 0]
    tan_half_fov_y = 1.0 / c2c[1, 1]
    right = w2c[0, :3]
    up = w2c[1, :3]
    fwd = -w2c[2, :3]
    d = (
        nd[..., 0:1] * right * tan_half_fov_y * aspect
        + nd[..., 1:2] * up * tan_half_fov_y
        + fwd
    )
    d = d / (d * d).sum(-1, keepdim=True).sqrt()
    o = cam["eye"].expand(d.shape)
    return o, d


def thin_lens_rays(cam: dict, uv: torch.Tensor, lens_u: torch.Tensor):
    """Thin-lens depth-of-field rays (ray.glsl:46-79); lens_u (..., 2)
    uniforms pick the point on the aperture disk."""
    o0, d0 = pinhole_rays(cam, uv)
    fwd = -cam["world_to_camera"][2, :3]
    theta = lens_u[..., 0] * 2.0 * math.pi
    radius = lens_u[..., 1]
    u = torch.cos(theta) * torch.sqrt(radius)
    v = torch.sin(theta) * torch.sqrt(radius)
    focal_length = cam["focal_length"]
    focus_point = o0 + d0 * (
        cam["focus_distance"] / (d0 * fwd).sum(-1, keepdim=True))
    f_stop = focal_length / cam["aperture_diameter"]
    coc_radius = focal_length / (2.0 * f_stop)
    lens_pos_cam = torch.stack(
        [u * coc_radius, v * coc_radius, torch.zeros_like(u)], dim=-1)
    c2w = cam["camera_to_world"]
    o = lens_pos_cam @ c2w[:3, :3].T + c2w[:3, 3]
    d = focus_point - o
    d = d / (d * d).sum(-1, keepdim=True).sqrt()
    return o, d


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Wächter-Binder origin offset along the normal, bit-level as the
    GLSL: integer offset of the float's bits scaled by 256*n, with a
    fixed-point fallback near the origin."""
    of_i = (256.0 * n).to(torch.int32)
    bits = p.contiguous().view(torch.int32)
    shifted = torch.where(p < 0.0, bits - of_i, bits + of_i)
    p_int = shifted.view(torch.float32)
    p_float = p + (1.0 / 65536.0) * n
    return torch.where(torch.abs(p) < 1.0 / 32.0, p_float, p_int)
