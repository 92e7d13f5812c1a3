"""G-buffer encodings.

Counterpart of prosper_tpu/mathx/packing.py `signed_oct_encode`,
`signed_oct_decode` and `pack_velocity` (:78-104): the signed-octahedron
normal of gbuffer.frag:40-55 (decoded as visible_surface.glsl
signedOctDecode) and the R16G16 snorm velocity clamp (gbuffer.frag:84).
"""

from __future__ import annotations

import torch


def signed_oct_encode(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normal -> (..., 3) encoded."""
    denom = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    n = n / torch.clamp_min(denom, 1e-20)[..., None]
    out_y = n[..., 1] * 0.5 + 0.5
    out_x = n[..., 0] * 0.5 + out_y
    out_y = n[..., 0] * -0.5 + out_y
    out_z = torch.clamp(n[..., 2] * 3.40282e38, 0.0, 1.0)
    return torch.stack([out_x, out_y, out_z], dim=-1)


def signed_oct_decode(e: torch.Tensor) -> torch.Tensor:
    """Inverse of signed_oct_encode."""
    x, y, z = e[..., 0], e[..., 1], e[..., 2]
    nx = x - y
    ny = x + y - 1.0
    nz = (z * 2.0 - 1.0) * (1.0 - nx.abs() - ny.abs())
    n = torch.stack([nx, ny, nz], dim=-1)
    return n / (n * n).sum(-1, keepdim=True).sqrt()


def pack_velocity(v: torch.Tensor) -> torch.Tensor:
    """Clamp NDC velocity to [-1, 1] like the R16G16 snorm target."""
    return torch.clamp(v, -1.0, 1.0)
