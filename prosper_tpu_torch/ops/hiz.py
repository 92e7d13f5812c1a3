"""Hierarchical depth (HiZ) pyramid.

Counterpart of prosper_tpu/ops/hiz.py `hiz_dimensions` (:20) and
`build_hiz` (:28), hiz_downsampler.comp of the reference: reverse-z MIN
reduction over power-of-2 rounded dimensions, at most 12 mips, the
depth padded with 1.0 (near, neutral for the min).
"""

from __future__ import annotations

import math

import torch

MAX_HIZ_MIPS = 12


def hiz_dimensions(width: int, height: int) -> tuple[int, int]:
    """Mip-0 size: half the render resolution rounded up to a power of 2."""
    w = 1 << int(math.ceil(math.log2(max(width // 2, 1))))
    h = 1 << int(math.ceil(math.log2(max(height // 2, 1))))
    return w, h


def build_hiz(depth: torch.Tensor, width: int, height: int) -> list:
    """(H, W) reverse-z depth -> [mip0 .. mipN]; mip 0 is the padded
    half-resolution min-reduction ("hiz mip 0 is depth mip 1",
    draw_list_culler.comp:129-131)."""
    hw, hh = hiz_dimensions(width, height)
    padded = torch.ones((hh * 2, hw * 2), dtype=depth.dtype,
                        device=depth.device)
    padded[:height, :width] = depth
    mip = padded.reshape(hh, 2, hw, 2).amin(dim=(1, 3))
    mips = [mip]
    while min(mip.shape) > 1 and len(mips) < MAX_HIZ_MIPS:
        h, w = mip.shape
        mip = mip.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))
        mips.append(mip)
    return mips
