"""Luminance and the HSV conversions of the display transform.

Counterpart of prosper_tpu/mathx/color.py (`luminance`, `rgb_to_hsv`,
`hsv_to_rgb`), math.glsl:15-78 of the reference, branchless with
torch.where.
"""

from __future__ import annotations

import torch


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Y' = dot((.299, .587, .114), rgb) (math.glsl:15); c (..., 3).
    Scalar weights: a weight tensor made from a list would be a
    host-to-device copy on every call."""
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """HSV with hue in [0, 6) (math.glsl:17-42)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    value = torch.maximum(torch.maximum(r, g), b)
    vmc = torch.minimum(torch.minimum(r, g), b)
    chroma = value - vmc
    safe = torch.where(chroma == 0.0, 1.0, chroma)
    hue_r = torch.remainder((g - b) / safe, 6.0)
    hue_g = (b - r) / safe + 2.0
    hue_b = (r - g) / safe + 4.0
    hue = torch.where(value == r, hue_r, torch.where(value == g, hue_g, hue_b))
    hue = torch.where(chroma == 0.0, 0.0, hue)
    sat = torch.where(
        value == 0.0, 0.0, chroma / torch.where(value == 0.0, 1.0, value)
    )
    return torch.stack([hue, sat, value], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv (math.glsl:44-78)."""
    hue, sat, value = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    chroma = value * sat
    x = chroma * (1.0 - torch.abs(torch.remainder(hue, 2.0) - 1.0))
    z = torch.zeros_like(chroma)

    def pick(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    h = hue[..., None]
    rgb = torch.where(
        h < 1.0, pick(chroma, x, z),
        torch.where(
            h < 2.0, pick(x, chroma, z),
            torch.where(
                h < 3.0, pick(z, chroma, x),
                torch.where(
                    h < 4.0, pick(z, x, chroma),
                    torch.where(h < 5.0, pick(x, z, chroma), pick(chroma, z, x)),
                ),
            ),
        ),
    )
    return rgb + (value - chroma)[..., None]
