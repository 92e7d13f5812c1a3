"""The renderer's per-pixel random streams (random.glsl of sndels/prosper).

pcg3d over three u32 words seeded with (px, py, frame index); each draw
advances the state and reads one, two or three words as u32 / 2**32.
u32 words are held in int64 tensors; products are formed from 16-bit
halves so that none leaves the int64 range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 words a (int64 tensor) and b (an int or
    such a tensor)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg(v: torch.Tensor) -> torch.Tensor:
    state = (mul32(v & M32, 747796405) + 2891336453) & M32
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def pcg3d(s: torch.Tensor) -> torch.Tensor:
    v = (mul32(s, 1664525) + 1013904223) & M32
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + mul32(y, z)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + mul32(y, z)) & M32
    y = (y + mul32(z, x)) & M32
    z = (z + mul32(x, y)) & M32
    return torch.stack([x, y, z], dim=-1)


def to01(u: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 in [0, 1]: rounded conversion, then / 2**32."""
    return u.to(torch.float32) / 4294967296.0


def seed(px: torch.Tensor, py: torch.Tensor, frame: int) -> torch.Tensor:
    f = torch.full_like(px, int(frame) & M32)
    return torch.stack([px & M32, py & M32, f], dim=-1)


def draw1(s):
    s = pcg3d(s)
    return s, to01(s[..., 0])


def draw2(s):
    s = pcg3d(s)
    return s, to01(s[..., :2])
