"""Bloom: the multi-resolution blur and the FFT convolution.

Counterpart of prosper_tpu/ops/bloom.py (`separate`, `reduce_mips`,
`_blur_pass`, `multi_res_blur`, `compose`, `bloom_multi_res`,
`generate_kernel`, `prepare_kernel`, `bloom_fft`), bloom/*.comp of the
reference: threshold at half (or quarter) resolution, a 3-mip box chain,
a separable 4-tap blur per mip with the anamorphic streak on mip 1's
horizontal pass, and the compose blend (0.9, 0.04, 0.04); or the FFT
path: a procedural star/halo kernel, corner-wrapped, convolved through
torch.fft with convolutionScale 2 / kernelDim.

The streak is a depthwise 1-D convolution, written as one batched
float32 product with a banded matrix per channel (torch.bmm, which keeps
float32 unless the process asks for TF32 matmuls; cuDNN's depthwise
convolution would take TF32 by default on the card, and its 480-tap
form is slow there).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

THRESHOLD_DEFAULT = 1.0
BLEND_FACTORS = (0.9, 0.04, 0.04)

_OFFSETS = (-2.089779143016758, -0.38698196063011614, 1.2004365440663936,
            3.0)
_WEIGHTS = (0.0666055522709221, 0.6249460483713625, 0.3024686099546741,
            0.005979789403041253)


def _f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


def bilinear_border(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with a transparent black border; uv (..., 2)."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def g(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi.to(torch.int32), 0, h - 1).long()
        xc = torch.clamp(xi.to(torch.int32), 0, w - 1).long()
        return torch.where(inside[..., None], img[yc, xc], 0.0)

    return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x0 + 1) * fx * (1 - fy)
            + g(y0 + 1, x0) * (1 - fx) * fy + g(y0 + 1, x0 + 1) * fx * fy)


def _grid(h: int, w: int, device, offset: float = 0.0):
    """(ys, xs) (h, w) float32 coordinate grids, + offset."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + offset
    xs = torch.arange(w, dtype=torch.float32, device=device) + offset
    return torch.meshgrid(ys, xs, indexing="ij")


def _inv(h: int, w: int, device) -> torch.Tensor:
    return torch.tensor([_f32(1.0 / w), _f32(1.0 / h)], dtype=torch.float32,
                        device=device)


def separate(illumination: torch.Tensor, threshold: float = THRESHOLD_DEFAULT,
             quarter: bool = False) -> torch.Tensor:
    """The highlights above threshold at half (bilinear quad centers) or
    quarter resolution (a 4-tap average) (separate.comp)."""
    h, w = illumination.shape[:2]
    dev = illumination.device
    inv = _inv(h, w, dev)
    if not quarter:
        ys, xs = _grid(h // 2, w // 2, dev)
        out = bilinear_border(illumination,
                              torch.stack([xs * 2, ys * 2], dim=-1) * inv)
    else:
        ys, xs = _grid(h // 4, w // 4, dev)
        base = torch.stack([xs * 4, ys * 4], dim=-1)
        acc = 0.0
        for ox, oy in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            off = torch.tensor([float(ox), float(oy)], dtype=torch.float32,
                               device=dev)
            acc = acc + bilinear_border(illumination, (base + off) * inv)
        out = acc / 4.0
    return torch.clamp_min(out - threshold, 0.0)


def reduce_mips(img: torch.Tensor, n_mips: int = 3) -> list[torch.Tensor]:
    """Box-filter mip chain [mip0 .. mip n-1] (the Reduce/SPD pass)."""
    mips = [img]
    for _ in range(n_mips - 1):
        m = mips[-1]
        h, w = m.shape[:2]
        m = m[: h // 2 * 2, : w // 2 * 2]
        mips.append(m.reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3)))
    return mips


def streak_kernel(w: int) -> np.ndarray:
    """(K, 3) float32 taps of the anamorphic streak at mip width w
    (blur.comp:52-70), tap k reading pixel x + k - w // 2."""
    shw = w // 2
    i = np.arange(-shw, shw, dtype=np.float64)
    t = np.clip(np.abs(i) / 10.0, 0.0, 1.0)[:, None]
    tint = np.array([0.05, 0.05, 1.0]) + (
        np.array([0.01, 0.01, 1.0]) - np.array([0.05, 0.05, 1.0])) * t
    scale = (4.0 * (np.abs(np.sin(i * 0.5)) + np.abs(np.cos(i * 0.95))
                    + np.abs(np.sin(i * 0.75)))
             * (150.0 / np.maximum(0.015 * i * i + np.abs(i), 1.0)))
    return (tint * scale[:, None] / (w * 2.0)).astype(np.float32)


def _blur_pass(img: torch.Tensor, vertical: bool, streak: bool):
    h, w = img.shape[:2]
    dev = img.device
    inv = _inv(h, w, dev)
    ys, xs = _grid(h, w, dev, 0.5)
    uv = torch.stack([xs, ys], dim=-1) * inv
    direction = torch.tensor([0.0, 1.0] if vertical else [1.0, 0.0],
                             dtype=torch.float32, device=dev)
    out = torch.zeros_like(img)
    for o, wgt in zip(_OFFSETS, _WEIGHTS):
        out = out + bilinear_border(img, uv + direction * _f32(o) * inv) * (
            _f32(wgt))
    if streak:
        # integer-pixel taps on pixel centers are exact texel reads: a
        # per-channel 1-D correlation along x over a zero border, as one
        # batched product with each channel's banded (W, W + K - 1) matrix
        kern = torch.as_tensor(streak_kernel(w), device=dev)  # (K, 3)
        K, shw = kern.shape[0], w // 2
        x = torch.arange(w, device=dev)[:, None]
        i = torch.arange(w + K - 1, device=dev)[None, :]
        band = ((i - x) >= 0) & ((i - x) < K)
        toeplitz = torch.where(band[None], kern.T[:, torch.clamp(i - x, 0,
                                                                 K - 1)],
                               0.0)  # (3, W, W + K - 1)
        rows = F.pad(img.permute(2, 0, 1), (shw, K - 1 - shw))  # (3, H, .)
        out = out + torch.bmm(rows, toeplitz.transpose(1, 2)).permute(
            1, 2, 0)
    return out


def multi_res_blur(highlights: torch.Tensor,
                   streak: bool = True) -> list[torch.Tensor]:
    """Reduce + the separable blur of each mip -> blurred mips 0-2."""
    out = []
    for lvl, m in enumerate(reduce_mips(highlights, 3)):
        hpass = _blur_pass(m, vertical=False, streak=streak and lvl == 1)
        out.append(_blur_pass(hpass, vertical=True, streak=False))
    return out


def compose(illumination: torch.Tensor, mips: list, blend=BLEND_FACTORS):
    """Upsample the mips bilinearly and add them, blended
    (compose.comp)."""
    h, w = illumination.shape[:2]
    ys, xs = _grid(h, w, illumination.device, 0.5)
    uv = torch.stack([xs / w, ys / h], dim=-1)
    highlight = 0.0
    for m, b in zip(mips, blend):
        highlight = highlight + bilinear_border(m, uv) * b
    return illumination + highlight


def bloom_multi_res(illumination: torch.Tensor,
                    threshold: float = THRESHOLD_DEFAULT,
                    quarter: bool = False, streak: bool = True):
    """The multi-resolution blur bloom (the default, Bloom.hpp:58)."""
    hl = separate(illumination, threshold, quarter)
    return compose(illumination, multi_res_blur(hl, streak))


# ---------------------------------------------------------------------------
# FFT technique


def _gaussian(x, a, b, c):
    return a * torch.exp(-(x - b * b) / (2 * c * c))


def _mod(x, y: float):
    """jnp.mod: the exact remainder (fmod) moved to the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _sd_star(p, r, n, w):
    """iq's n-star SDF (generate_kernel.comp:22-46)."""
    m = n + w * (2.0 - n)
    an = np.pi / n
    en = np.pi / m
    # float32 constants, rounded as the JAX package rounds them
    racs = np.float32(r) * np.array([np.cos(an), np.sin(an)], np.float32)
    ecs = np.array([np.cos(en), np.sin(en)], np.float32)
    t_hi = float(racs[1] / ecs[1])
    racs, ecs = [float(v) for v in racs], [float(v) for v in ecs]
    px = torch.abs(p[..., 0])
    py = p[..., 1]
    bn = _mod(torch.atan2(px, py), 2.0 * an) - an
    plen = torch.sqrt(px * px + py * py)
    p2x = plen * torch.cos(bn) - racs[0]
    p2y = plen * torch.abs(torch.sin(bn)) - racs[1]
    t = torch.clamp(-(p2x * ecs[0] + p2y * ecs[1]), 0.0, t_hi)
    p2x = p2x + ecs[0] * t
    p2y = p2y + ecs[1] * t
    return torch.sqrt(p2x * p2x + p2y * p2y) * torch.sign(p2x)


def _rotate(p, a):
    ca, sa = float(np.cos(a)), float(np.sin(a))
    return torch.stack([ca * p[..., 0] + sa * p[..., 1],
                        ca * p[..., 1] - sa * p[..., 0]], dim=-1)


def generate_kernel(dim: int, supersample: int = 4,
                    device="cpu") -> torch.Tensor:
    """The procedural star/halo kernel (generate_kernel.comp) ->
    (dim, dim, 4), the reference's RG/BA filter split."""
    ss = supersample
    px_size = 1.0 / (dim * ss)
    coords = ((torch.arange(dim * ss, dtype=torch.float32, device=device)
               + 0.5) * px_size * 2.0 - 1.0)
    py, px = torch.meshgrid(coords, coords, indexing="ij")
    p = torch.stack([px, py], dim=-1)
    plen = torch.sqrt((p * p).sum(-1))
    base = _gaussian(plen, 1.5, 0.0, 0.055)
    ret = torch.stack([base, base, base, base], dim=-1)
    d1 = _sd_star(p, 0.5, 4.0, 0.075)
    d2 = _sd_star(_rotate(p, np.pi / 4), 0.35, 4.0, 0.05)
    star = torch.minimum(d1, d2) < 0
    ret = ret + torch.where(star[..., None], ret, 0.0)
    t0 = torch.tensor([0.05, 0.05, 1.0, 1.0], dtype=torch.float32,
                      device=device)
    t1 = torch.tensor([0.01, 0.01, 1.0, 1.0], dtype=torch.float32,
                      device=device)
    tint = t0 + (t1 - t0) * torch.clamp(torch.abs(px) * 6, 0, 1)[..., None]
    osc = (torch.abs(torch.sin(px * 50.0)) + torch.abs(torch.cos(px * 95.0))
           + torch.abs(torch.sin(px * 75.0)))
    streak = 0.5 * tint * (
        osc * _gaussian(torch.abs(px) * 10.0, 0.5, 1.0, 1.0))[..., None]
    v = ret + torch.where((torch.abs(py) < 0.005)[..., None], streak, 0.0)
    return v.reshape(dim, ss, dim, ss, 4).mean(dim=(1, 3))


def prepare_kernel(kernel: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Center -> corner wrap, G and A zeroed (prepare_kernel.comp)."""
    in_dim = kernel.shape[0]
    shift = in_dim // 2
    rolled = torch.roll(kernel, (-shift, -shift), dims=(0, 1))
    out = torch.zeros((out_dim, out_dim, 4), dtype=kernel.dtype,
                      device=kernel.device)
    half = min(in_dim, out_dim) // 2
    if half:
        out[:half, :half] = rolled[:half, :half]
        out[:half, -half:] = rolled[:half, -half:]
        out[-half:, :half] = rolled[-half:, :half]
        out[-half:, -half:] = rolled[-half:, -half:]
    out[..., 1] = 0.0
    out[..., 3] = 0.0
    return out


def fft_dim(h: int, w: int) -> int:
    """The FFT extent of an (h, w) highlight image: the next power of 2."""
    return 1 << int(math.ceil(math.log2(max(h, w))))


def bloom_fft(illumination: torch.Tensor,
              threshold: float = THRESHOLD_DEFAULT, quarter: bool = False,
              kernel_image: torch.Tensor | None = None) -> torch.Tensor:
    """The FFT-convolution bloom; kernel_image (generate_kernel's, cached
    across frames as the reference preserves it) or None to make one."""
    hl = separate(illumination, threshold, quarter)
    h, w = hl.shape[:2]
    dim = fft_dim(h, w)
    if kernel_image is None:
        kernel_image = generate_kernel(dim, device=hl.device)
    kern = prepare_kernel(kernel_image, dim)
    pad = torch.zeros((dim, dim, 3), dtype=hl.dtype, device=hl.device)
    pad[:h, :w] = hl
    scale = 2.0 / kernel_image.shape[0]
    f_img = torch.fft.fft2(pad, dim=(0, 1))
    # R and G with the R filter, B with the B filter (prepare_kernel zeroes
    # G and A, so the packed RG/BA complex trick reduces to this)
    f_k_r = torch.fft.fft2(kern[..., 0])
    f_k_b = torch.fft.fft2(kern[..., 2])
    f_out = torch.stack([f_img[..., 0] * f_k_r, f_img[..., 1] * f_k_r,
                         f_img[..., 2] * f_k_b], dim=-1)
    conv = torch.fft.ifft2(f_out, dim=(0, 1)).real * scale
    conv = torch.clamp_min(conv[:h, :w], 0.0)
    return compose(illumination, [conv], blend=(1.0,))
