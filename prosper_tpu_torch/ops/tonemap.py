"""Display transform: exposure -> HSV contrast -> 3D LUT -> gamma.

Counterpart of prosper_tpu/ops/tonemap.py (`tone_map`, `pack_lut_quads`,
`sample_lut_trilinear`, `load_tony_mc_mapface`), tone_map.comp:17-60 of
the reference. The Tony McMapface LUT (tony_mc_mapface.dds, R9G9B9E5)
ships with the reference checkout, not with this repo: load_tony_mc_mapface
reads it from a path, and callers without it pass synthetic_lut() or any
(48, 48, 48, 3) LUT through pack_lut_quads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.dds import read_dds
from ..mathx.color import hsv_to_rgb, rgb_to_hsv
from ..utils.profiler import gprofiler

LUT_DIMS = 48


def device_lut(lut, device) -> torch.Tensor:
    """The display LUT as float32 on `device`. A host array goes up to
    the card by a pageable copy, which waits for it (a wait span)."""
    on_card = isinstance(lut, torch.Tensor) and lut.is_cuda
    if on_card or torch.device(device).type != "cuda":
        return torch.as_tensor(lut, dtype=torch.float32, device=device)
    with gprofiler.wait("tonemap.lut_upload"):
        return torch.as_tensor(lut, dtype=torch.float32, device=device)


def load_tony_mc_mapface(path: str) -> np.ndarray:
    """The Tony McMapface DDS at path -> its packed (48**3, 24) float32
    LUT (pack_lut_quads)."""
    lut = read_dds(path).mips[0]
    if lut.shape != (LUT_DIMS, LUT_DIMS, LUT_DIMS, 3):
        raise ValueError(f"{path}: not a {LUT_DIMS}^3 RGB LUT: {lut.shape}")
    return pack_lut_quads(lut.astype(np.float32))


def pack_lut_quads(lut: np.ndarray) -> np.ndarray:
    """(48, 48, 48, 3) -> (48**3, 24): row (z, y, x) holds both
    z-slices' clamped x/y bilinear quads [quad(z) | quad(z+1)]."""
    d = LUT_DIMS
    i = np.arange(d)
    i1 = np.minimum(i + 1, d - 1)
    q = np.stack(
        [lut, lut[:, :, i1], lut[:, i1, :], lut[:, i1, :][:, :, i1]], axis=-2
    )  # (z, y, x, 4, 3)
    rows = q.reshape(d, d * d, 12)
    rows_z1 = np.concatenate([rows[1:], rows[-1:]], axis=0)
    return np.concatenate([rows, rows_z1], axis=-1).reshape(
        d * d * d, 24
    ).astype(np.float32)


def synthetic_lut() -> np.ndarray:
    """A smooth (48, 48, 48, 3) stand-in LUT: each channel a soft
    shoulder of its own coordinate, mixed slightly across channels."""
    c = (np.arange(LUT_DIMS, dtype=np.float32) + 0.5) / LUT_DIMS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    rgb = np.stack([x, y, z], axis=-1)
    mixed = 0.9 * rgb + 0.1 * rgb.mean(axis=-1, keepdims=True)
    return (mixed * (1.5 - 0.5 * mixed)).astype(np.float32)


def sample_lut_trilinear(lut: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """Trilinear fetch of a packed (48**3, 24) LUT; uvw in [0, 1]^3
    already mapped to texel centres."""
    d = LUT_DIMS
    c = uvw * d - 0.5
    c0 = torch.floor(c)
    f = c - c0
    i0 = torch.clamp(c0.to(torch.int64), 0, d - 1)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    qq = lut[(z0 * d + y0) * d + x0]

    def bil(q):
        return (
            (q[..., 0:3] * (1 - fx) + q[..., 3:6] * fx) * (1 - fy)
            + (q[..., 6:9] * (1 - fx) + q[..., 9:12] * fx) * fy
        )

    return bil(qq[..., 0:12]) * (1 - fz) + bil(qq[..., 12:24]) * fz


def tony_mc_mapface(lut, stimulus):
    """tone_map.comp:16-28."""
    encoded = stimulus / (stimulus + 1.0)
    uv = encoded * ((LUT_DIMS - 1.0) / LUT_DIMS) + 0.5 / LUT_DIMS
    return sample_lut_trilinear(lut, uv)


def tone_map(color, lut, exposure: float = 1.0, contrast: float = 1.0):
    """(..., 3) linear HDR -> (..., 3) gamma-encoded display."""
    color = color * exposure
    hsv = rgb_to_hsv(color)
    v = torch.pow(torch.clamp_min(hsv[..., 2], 0.0), contrast)
    color = hsv_to_rgb(torch.cat([hsv[..., :2], v[..., None]], dim=-1))
    color = tony_mc_mapface(lut, color)
    return torch.pow(torch.clamp_min(color, 0.0), 1.0 / 2.2)
