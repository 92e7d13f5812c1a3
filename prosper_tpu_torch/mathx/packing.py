"""Vertex and G-buffer encodings.

Counterpart of prosper_tpu/mathx/packing.py: `pack_snorm_10_10_10_2`
and `unpack_snorm_10_10_10_2` (:34-73, the A2B10G10R10 snorm of the
reference's packed normals and tangents, Mesh.hpp:13-14), in numpy for
the scene's vertex arrays; `signed_oct_encode`, `signed_oct_decode` and
`pack_velocity` (:78-104): the signed-octahedron normal of
gbuffer.frag:40-55 (decoded as visible_surface.glsl signedOctDecode) and
the R16G16 snorm velocity clamp (gbuffer.frag:84).
"""

from __future__ import annotations

import numpy as np
import torch


def _snorm_quant(x: np.ndarray, bits: int) -> np.ndarray:
    scale = float((1 << (bits - 1)) - 1)  # 511 for 10-bit, 1 for 2-bit
    q = np.rint(np.clip(x, -1.0, 1.0) * scale).astype(np.int32)
    return q & ((1 << bits) - 1)


def pack_snorm_10_10_10_2(v: np.ndarray, w: np.ndarray | None = None):
    """Pack (..., 3) [+ optional w in {-1, 1}] into uint32 A2B10G10R10
    snorm: R in bits 0-9, G 10-19, B 20-29, A 30-31."""
    r = _snorm_quant(v[..., 0], 10)
    g = _snorm_quant(v[..., 1], 10)
    b = _snorm_quant(v[..., 2], 10)
    if w is None:
        a = np.zeros(v.shape[:-1], dtype=np.int32)
    else:
        a = _snorm_quant(w, 2)
    return (r | (g << 10) | (b << 20) | (a << 30)).astype(np.uint32)


def _snorm_dequant(q: np.ndarray, bits: int) -> np.ndarray:
    scale = np.float32((1 << (bits - 1)) - 1)
    q = (q & np.uint32((1 << bits) - 1)).astype(np.int32)
    q = np.where(q >= 1 << (bits - 1), q - (1 << bits), q)  # sign extend
    return np.maximum(q.astype(np.float32) / scale, np.float32(-1.0))


def unpack_snorm_10_10_10_2(p: np.ndarray):
    """uint32 -> ((..., 3) vector, w scalar), float32."""
    p = np.asarray(p, np.uint32)
    r = _snorm_dequant(p, 10)
    g = _snorm_dequant(p >> np.uint32(10), 10)
    b = _snorm_dequant(p >> np.uint32(20), 10)
    a = _snorm_dequant(p >> np.uint32(30), 2)
    return np.stack([r, g, b], axis=-1), a


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
