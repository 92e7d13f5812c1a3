"""Bokeh depth of field: Abadie's "A Life of a Bokeh" scatter-as-gather.

Counterpart of prosper_tpu/ops/dof.py (`max_bg_coc_half_res`, `setup`,
`flatten`, `dilate`, the octaweb rings, `gather_background`,
`gather_foreground`, `median3x3`, `combine`, `depth_of_field`),
dof/*.comp of the reference: a half-resolution bilateral downsample and
CoC, 8x8 tile min/max, dilation, the 6-ring octaweb gather (background
buckets blended back to front, foreground with Jimenez's alpha), a 3x3
luminance median and the combine.

The JAX package loops over the samples of a ring one at a time
(lax.fori_loop); here a ring's samples are evaluated together and summed,
the rings in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mathx.color import luminance
from ..scene.camera import SENSOR_WIDTH
from .taa import edge_pad

MAX_FG_COC_FACTOR = 2.0
RING_COUNT = 6
_SINGLE_PIXEL_RADIUS = 0.7071
GATHER_RADIUS = 4  # tiles (Dilate.cpp:106-120, a fixed conservative radius)


def max_bg_coc_half_res(cam: dict, width: int) -> torch.Tensor:
    """maxBackgroundCoC in half-resolution pixels (Setup.cpp:163-171)."""
    f = cam["focal_length"]
    units = (cam["aperture_diameter"] * f) / (cam["focus_distance"] - f)
    return (units / SENSOR_WIDTH) * (width // 2)


def _bilateral4(cw00, cw01, cw10, cw11):
    """bilateral.glsl bilateralFilter of four (..., 4) color + CoC taps."""
    coc_out = torch.minimum(torch.minimum(cw01[..., 3], cw11[..., 3]),
                            torch.minimum(cw10[..., 3], cw00[..., 3]))

    def w(cw):
        return torch.clamp(1.0 - (coc_out - cw[..., 3]), 0.0, 1.0)

    w01, w11, w10, w00 = w(cw01), w(cw11), w(cw10), w(cw00)
    norm = w01 + w11 + w10 + w00
    return (w01[..., None] * cw01 + w11[..., None] * cw11
            + w10[..., None] * cw10 + w00[..., None] * cw00) / (
        torch.clamp_min(norm[..., None], 1e-20))


def setup(illumination: torch.Tensor, view_depth: torch.Tensor, cam: dict):
    """Half-resolution illumination and CoC. view_depth (H, W): positive
    distances along -z. Returns (half_illum (h, w, 3), half_coc (h, w))."""
    H, W = view_depth.shape
    h, w = H // 2, W // 2
    max_bg = max_bg_coc_half_res(cam, W)
    max_coc = max_bg * MAX_FG_COC_FACTOR
    il = illumination[: h * 2, : w * 2].reshape(h, 2, w, 2, 3)
    vd = view_depth[: h * 2, : w * 2].reshape(h, 2, w, 2)
    coc = torch.maximum((1.0 - cam["focus_distance"] / vd) * max_bg, -max_coc)
    cw = torch.cat([il, coc[..., None]], dim=-1)
    out = _bilateral4(cw[:, 0, :, 1], cw[:, 1, :, 1], cw[:, 1, :, 0],
                      cw[:, 0, :, 0])
    return out[..., :3], out[..., 3]


def flatten(half_coc: torch.Tensor):
    """8x8 tile min and max CoC (flatten.comp)."""
    h, w = half_coc.shape
    th, tw = -(-h // 8), -(-w // 8)
    ys = torch.clamp(torch.arange(th * 8, device=half_coc.device), max=h - 1)
    xs = torch.clamp(torch.arange(tw * 8, device=half_coc.device), max=w - 1)
    tiles = half_coc[ys][:, xs].reshape(th, 8, tw, 8)
    return tiles.amin(dim=(1, 3)), tiles.amax(dim=(1, 3))


def dilate(tile_min: torch.Tensor, tile_max: torch.Tensor,
           gather_radius: int):
    """dilate.comp:30-50."""
    th, tw = tile_min.shape
    r = gather_radius
    dmin = torch.full_like(tile_min, float("inf"))
    dmax = torch.full_like(tile_max, float("-inf"))
    pmin = edge_pad(tile_min, r)
    pmax = edge_pad(tile_max, r)
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            nmin = pmin[r + i: r + i + th, r + j: r + j + tw]
            nmax = pmax[r + i: r + i + th, r + j: r + j + tw]
            dist = float(np.hypot(i, j)) * 8.0
            dmin = torch.where(dist <= torch.abs(nmin) + 4.0,
                               torch.minimum(dmin, nmin), dmin)
            dmax = torch.where(dist <= torch.abs(nmax) + 4.0,
                               torch.maximum(dmax, nmax), dmax)
    return dmin, dmax


def _octaweb_offsets():
    """The unit offsets of each ring (radii scale them per pixel)."""
    rings = []
    for ring in range(RING_COUNT):
        n = 1 if ring == 0 else 8 * ring
        rim = 2.0 * np.pi / n
        phis = np.arange(n) * rim + (rim * 0.5 if ring % 2 == 0 else 0.0)
        rings.append(np.stack([np.cos(phis), np.sin(phis)],
                              -1).astype(np.float32))
    return rings


RINGS = _octaweb_offsets()


def _mip_chain(img: torch.Tensor, n: int = 4) -> list[torch.Tensor]:
    mips = [img]
    for _ in range(n - 1):
        m = mips[-1]
        h, w = m.shape[:2]
        mips.append(m[: h // 2 * 2, : w // 2 * 2].reshape(
            h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3)))
    return mips


def _pyramid(mips: list) -> tuple:
    """The mip chain flattened for level-indexed taps: (rows (N, C), row
    offset, height and width of each level)."""
    dev = mips[0].device
    sizes = [m.shape[:2] for m in mips]
    offs = np.cumsum([0] + [h * w for h, w in sizes[:-1]])
    return (torch.cat([m.reshape(-1, m.shape[-1]) for m in mips]),
            torch.as_tensor(offs, device=dev),
            torch.tensor([h for h, _ in sizes], device=dev),
            torch.tensor([w for _, w in sizes], device=dev))


def _bilinear_at(pyr: tuple, uv: torch.Tensor, lvl: torch.Tensor):
    """taa.bilinear_clamped of each point's own level lvl of the chain."""
    rows, offs, hs, ws = pyr
    h, w = hs[lvl], ws[lvl]
    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    base = offs[lvl]

    def g(yi, xi):
        yi = torch.minimum(torch.clamp_min(yi.to(torch.int32), 0), h - 1)
        xi = torch.minimum(torch.clamp_min(xi.to(torch.int32), 0), w - 1)
        return rows[base + yi * w + xi]

    return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x0 + 1) * fx * (1 - fy)
            + g(y0 + 1, x0) * (1 - fx) * fy + g(y0 + 1, x0 + 1) * fx * fy)


def _sample_trilinear(pyr: tuple, uv: torch.Tensor, mip: torch.Tensor):
    """A trilinear sample of the half-resolution illumination chain: the
    taps of levels floor(mip) and the next, blended. The JAX package
    taps every level and keeps two by selects; the two sums are equal
    bit for bit (the other terms are exact zeros)."""
    n = pyr[2].shape[0]
    mip = torch.clamp(mip, 0.0, n - 1.0)
    m0 = torch.floor(mip)
    f = (mip - m0)[..., None]
    lo = m0.long()
    s0 = _bilinear_at(pyr, uv, lo)
    s1 = _bilinear_at(pyr, uv, torch.clamp_max(lo + 1, n - 1))
    return s0 * (1 - f) + torch.where((lo < n - 1)[..., None], s1 * f, 0.0)


def _sample_alpha(coc):
    return torch.clamp_max(
        1.0 / (math.pi * coc * coc),
        float(np.float32(1.0 / (np.pi * _SINGLE_PIXEL_RADIUS ** 2))))


def _nearest(img, uv):
    h, w = img.shape[:2]
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
    return img[y, x]


def _tile_lookup(arr, h, w):
    ty = torch.arange(h, device=arr.device) // 8
    tx = torch.arange(w, device=arr.device) // 8
    return arr[ty[:, None], tx[None, :]]


def _pixel_coords(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def _inv_res(h, w, device):
    return torch.tensor([float(np.float32(1.0 / w)),
                         float(np.float32(1.0 / h))], dtype=torch.float32,
                        device=device)


def gather_background(half_illum, half_coc, dil_min, dil_max):
    """gather.comp gatherBackground over every half-resolution pixel:
    rings from the outermost in, each sample sorted into the ring's
    bucket or the one beyond, the buckets blended back to front."""
    h, w = half_coc.shape
    dev = half_coc.device
    inv_res = _inv_res(h, w, dev)
    coord = _pixel_coords(h, w, dev)
    tmax = _tile_lookup(dil_max, h, w)
    pyr = _pyramid(_mip_chain(half_illum))
    ring_spacing = tmax / (RING_COUNT - 1)
    coc_img = half_coc[..., None]

    prev_cw = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    prev_coc = torch.zeros((h, w), dtype=torch.float32, device=dev)
    prev_n = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for ring in range(RING_COUNT - 1, -1, -1):
        offs = torch.as_tensor(RINGS[ring], device=dev)  # (n_s, 2)
        n_s = offs.shape[0]
        ring_radius = ring * ring_spacing
        bordering = (ring + 0.5 + 1.0) * ring_spacing
        s = ring_radius[None, ..., None] * offs[:, None, None, :]
        uv = (coord + s) * inv_res
        sc = _nearest(coc_img, uv)[..., 0]
        take = sc >= ring_radius
        to_cur = take & (sc < bordering)
        to_prev = take & ~(sc < bordering)
        mip = torch.clamp_min(torch.log2(torch.clamp_min(sc, 1e-6)) - 1.0,
                              0.0)
        sw = _sample_alpha(sc)
        col = _sample_trilinear(pyr, uv, mip)
        cw = torch.cat([col * sw[..., None], sw[..., None]], -1)
        cur_cw = torch.where(to_cur[..., None], cw, 0.0).sum(0)
        cur_coc = torch.where(to_cur, sc, 0.0).sum(0)
        cur_n = to_cur.to(torch.float32).sum(0)
        prev_cw = prev_cw + torch.where(to_prev[..., None], cw, 0.0).sum(0)
        prev_coc = prev_coc + torch.where(to_prev, sc, 0.0).sum(0)
        prev_n = prev_n + to_prev.to(torch.float32).sum(0)
        # blendBuckets
        cur_opacity = torch.clamp(cur_n / n_s, 0.0, 1.0)
        occluding = torch.clamp(
            prev_coc / torch.clamp_min(prev_n, 1e-20)
            - cur_coc / torch.clamp_min(cur_n, 1e-20), 0.0, 1.0)
        blend = torch.where(prev_cw[..., 3] == 0.0, 0.0,
                            1.0 - cur_opacity * occluding)
        prev_cw = prev_cw * blend[..., None] + cur_cw
        prev_coc = prev_coc * blend + cur_coc
        prev_n = prev_n * blend + cur_n
    color = prev_cw[..., :3] / torch.clamp_min(prev_cw[..., 3:4], 1e-5)
    return torch.where((tmax < 1.0)[..., None], 0.0, color)


def gather_foreground(half_illum, half_coc, dil_min, dil_max):
    """gather.comp gatherForeground over all 121 octaweb samples ->
    (h, w, 4) color and weight."""
    h, w = half_coc.shape
    dev = half_coc.device
    inv_res = _inv_res(h, w, dev)
    coord = _pixel_coords(h, w, dev)
    tmin = _tile_lookup(dil_min, h, w)
    kernel_radius = -tmin
    ring_spacing = kernel_radius / (RING_COUNT - 1)
    pyr = _pyramid(_mip_chain(half_illum))
    coc_img = half_coc[..., None]
    color_sum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    alpha_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    weight_sum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for ring, offs_np in enumerate(RINGS):
        offs = torch.as_tensor(offs_np, device=dev)
        ring_radius = float(ring) * ring_spacing
        s = ring_radius[None, ..., None] * offs[:, None, None, :]
        uv = (coord + s) * inv_res
        sc = -_nearest(coc_img, uv)[..., 0]
        ok = (sc >= 0.5) & (sc >= torch.sqrt((s * s).sum(-1)) - ring_spacing)
        mip = torch.clamp_min(
            torch.floor(torch.log2(torch.clamp_min(sc, 1e-6))) - 1.0, 0.0)
        sw = kernel_radius / torch.clamp_min(sc, 1e-5)
        col = _sample_trilinear(pyr, uv, mip)
        color_sum = color_sum + torch.where(ok[..., None],
                                            col * sw[..., None], 0.0).sum(0)
        alpha_sum = alpha_sum + torch.where(
            ok, _sample_alpha(sc) * torch.clamp(sc - 0.5, 0.0, 1.0),
            0.0).sum(0)
        weight_sum = weight_sum + torch.where(ok, sw, 0.0).sum(0)
    n_total = sum(len(o) for o in RINGS)
    color = color_sum / torch.clamp_min(weight_sum[..., None], 1e-3)
    weight = torch.clamp(
        2.0 * (1.0 / n_total)
        * (1.0 / _sample_alpha(torch.clamp_min(kernel_radius, 1e-5)))
        * alpha_sum, 0.0, 1.0)
    active = tmin <= -0.5
    return torch.where(active[..., None],
                       torch.cat([color, weight[..., None]], -1), 0.0)


def median3x3(cw: torch.Tensor) -> torch.Tensor:
    """The 3x3 luminance median (filter.comp): of equal luminances the
    first in row order, as a stable sort keeps it."""
    h, w = cw.shape[:2]
    padded = edge_pad(cw, 1)
    n = torch.stack([padded[dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3)])
    order = torch.argsort(luminance(n[..., :3]), dim=0, stable=True)
    med = order[4]
    idx = med[None, ..., None].expand(1, h, w, n.shape[-1])
    return torch.gather(n, 0, idx)[0]


def combine(illumination, fg_cw, bg_cw, half_coc):
    """combine.comp."""
    H, W = illumination.shape[:2]
    dev = illumination.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    coc = half_coc[(ys // 2)[:, None], (xs // 2)[None, :]]

    def at(img, dy, dx):
        h2, w2 = img.shape[:2]
        y = torch.clamp((ys[:, None] + dy) // 2, 0, h2 - 1)
        x = torch.clamp((xs[None, :] + dx) // 2, 0, w2 - 1)
        return img[y, x]

    bg00, bg10, bg11 = at(bg_cw, 0, 0), at(bg_cw, 1, 0), at(bg_cw, 1, 1)
    bg = (bg00 * 0.5 + bg10 * 0.5) * 0.5 + (bg10 * 0.5 + bg11 * 0.5) * 0.5
    out = illumination
    bg_factor = torch.clamp(coc - 1.0, 0.0, 1.0)
    out = torch.where((bg_factor > 0.0)[..., None],
                      out * (1 - bg_factor[..., None])
                      + bg[..., :3] * bg_factor[..., None], out)
    fg = _bilateral4(at(fg_cw, 1, 0), at(fg_cw, 1, 1), at(fg_cw, 0, 1),
                     at(fg_cw, 0, 0))
    return torch.where((fg[..., 3] > 0.0)[..., None],
                       out * (1 - fg[..., 3:4]) + fg[..., :3] * fg[..., 3:4],
                       out)


def depth_of_field(illumination: torch.Tensor, view_depth: torch.Tensor,
                   cam: dict) -> torch.Tensor:
    """The whole DoF chain in DepthOfField::record's order."""
    half_illum, half_coc = setup(illumination, view_depth, cam)
    tmin, tmax = flatten(half_coc)
    dmin, dmax = dilate(tmin, tmax, GATHER_RADIUS)
    bg = gather_background(half_illum, half_coc, dmin, dmax)
    bg = torch.cat([bg, torch.zeros_like(bg[..., :1])], -1)
    fg = gather_foreground(half_illum, half_coc, dmin, dmax)
    return combine(illumination, median3x3(fg), median3x3(bg), half_coc)
