"""PCG hashes and the stateful PT sample stream.

Counterpart of prosper_tpu/mathx/rng.py (`pcg`, `pcg3d`, `rng_to01`,
`make_state`, `rnd01`, `rnd2d01`, `rnd3d01`, `uint_to_color`,
`radical_inverse2`, `hammersley`), bit-exact with it.

torch has no usable uint32 arithmetic on the CPU (`+`, `>>` and `<<`
raise), so u32 words are carried as int64 tensors holding values in
[0, 2**32). Products are formed from 16-bit halves so no intermediate
leaves the int64 range; every result is masked back to 32 bits.
"""

from __future__ import annotations

import torch

from ..utils.profiler import gprofiler

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 words a and b (a tensor or an int)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(v) -> torch.Tensor:
    """Any integer tensor -> int64 words in [0, 2**32) (u32 wraparound)."""
    v = torch.as_tensor(v)
    return v.to(torch.int64) & _M32


def pcg(v: torch.Tensor) -> torch.Tensor:
    """pcg hash of u32 words (random.glsl:7-13)."""
    v = as_u32(v)
    state = (_mul32(v, 747796405) + 2891336453) & _M32
    word = _mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def pcg3d(v: torch.Tensor) -> torch.Tensor:
    """pcg3d hash of a (..., 3) u32 array (random.glsl:17-28)."""
    v = (_mul32(as_u32(v), 1664525) + 1013904223) & _M32
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    return torch.stack([x, y, z], dim=-1)


def rng_to01(u: torch.Tensor) -> torch.Tensor:
    """u32 -> [0, 1] float32 (random.glsl:42): exact-rounded conversion,
    then division by float32(0xFFFFFFFF) == 2**32, which is exact."""
    return u.to(torch.float32) / 4294967296.0


def make_state(px, py, frame) -> torch.Tensor:
    """Initial pcg_state = uvec3(px, py, frameIndex) (random.glsl:45)."""
    px = as_u32(px)
    py = as_u32(py).to(px.device)
    with gprofiler.wait("rng.make_state"):  # the frame index's upload
        frame = as_u32(frame).to(px.device).expand(px.shape)
    return torch.stack([px, py, frame], dim=-1)


def rnd01(state: torch.Tensor):
    """Advance state; return (new_state, one float in [0, 1])."""
    state = pcg3d(state)
    return state, rng_to01(state[..., 0])


def rnd2d01(state: torch.Tensor):
    state = pcg3d(state)
    return state, rng_to01(state[..., :2])


def rnd3d01(state: torch.Tensor):
    state = pcg3d(state)
    return state, rng_to01(state[..., :3])


def uint_to_color(x) -> torch.Tensor:
    """Pastel debug hash color of u32 words (random.glsl:30-40): three
    10-bit fields of pcg(x), each over 1023."""
    xr = pcg(x)
    rgb = torch.stack([(xr >> 20) & 0x3FF, (xr >> 10) & 0x3FF, xr & 0x3FF],
                      dim=-1)
    return rgb.to(torch.float32) / 1023.0


def radical_inverse2(i) -> torch.Tensor:
    """Base-2 radical inverse of u32 words by bit reversal
    (random.glsl:71-74)."""
    i = as_u32(i)
    rev = torch.zeros_like(i)
    for shift in range(32):
        rev = rev | (((i >> shift) & 1) << (31 - shift))
    return rev.to(torch.float32) * 2.32830643653896e-10


def hammersley(i, n: int) -> torch.Tensor:
    """Point i of the n-point Hammersley set: (..., 2) (i / n, the
    radical inverse of i)."""
    i = as_u32(i)
    return torch.stack([i.to(torch.float32) / float(n),
                        radical_inverse2(i)], dim=-1)
