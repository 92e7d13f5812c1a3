"""Material sampling over the quad-packed texture arena with mips.

Counterpart of prosper_tpu/ops/texture.py: `pack_material_tables`
(:126), `sample_material_packed` (:157) with its base-mip, ray-cone LOD
(trilinear, and anisotropic with duv_major) and fixed-mip paths,
`sample_alpha_packed` (:236), and the taps they call (`_decode4`,
`_wrap_coord`, `_bilinear_entry`, `sample_bilinear`, `sample_trilinear`,
`sample_aniso`, :22-123). sRGB decodes per texel before the filter, as
an sRGB view does.

Arena: `data` (N, 4) u32 bilinear quads — texel (x, y) and its +x, +y,
+xy REPEAT neighbours — held as int64 here; `table` (T, 13, 4) i32 mip
entries (off, w, h, flags), flags bit 0 = sRGB, bits 1-2 / 3-4 = u / v
wrap mode (0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT).
"""

from __future__ import annotations

import numpy as np
import torch


def _decode4(quads: torch.Tensor, srgb_mask, assume_linear=False):
    """(..., 4) u32 quads -> (..., 4, 4) linear RGBA per corner."""
    p = quads
    r = (p & 0xFF).to(torch.float32) / 255.0
    g = ((p >> 8) & 0xFF).to(torch.float32) / 255.0
    b = ((p >> 16) & 0xFF).to(torch.float32) / 255.0
    a = ((p >> 24) & 0xFF).to(torch.float32) / 255.0
    rgb = torch.stack([r, g, b], dim=-1)
    if not assume_linear:
        lin = torch.where(
            rgb <= 0.04045, rgb / 12.92, torch.pow((rgb + 0.055) / 1.055, 2.4)
        )
        rgb = torch.where(srgb_mask[..., None, None], lin, rgb)
    return torch.cat([rgb, a[..., None]], dim=-1)


def _wrap_coord(s, n, mode):
    """Texel index and bilinear fraction of normalized coordinate s on an
    n-texel axis under a glTF wrap mode."""
    nf = n.to(torch.float32)
    c = s * nf - 0.5
    clamped = torch.minimum(torch.clamp_min(c, 0.0), nf - 1.0)
    m = torch.remainder(c + 0.5, 2.0 * nf)
    mirrored = torch.minimum(
        torch.clamp_min(nf - torch.abs(m - nf) - 0.5, 0.0), nf - 1.0
    )
    cw = torch.where(mode == 1, clamped, torch.where(mode == 2, mirrored, c))
    c0 = torch.floor(cw)
    idx = c0.to(torch.int64)
    idx = torch.where(mode == 0, torch.remainder(idx, n), idx)
    return idx, cw - c0


def _bilinear_entry(arena: dict, entry, uv, assume_linear=False):
    """Bilinear sample given (R, 4) table entries (off, w, h, flags)."""
    off = entry[..., 0].long()
    w = entry[..., 1].long()
    h = entry[..., 2].long()
    flags = entry[..., 3].long()
    srgb = (flags & 1) > 0
    x0, fu = _wrap_coord(uv[..., 0], w, (flags >> 1) & 3)
    y0, fv = _wrap_coord(uv[..., 1], h, (flags >> 3) & 3)
    fu = fu[..., None]
    fv = fv[..., None]
    quads = arena["data"][off + y0 * w + x0]  # (R, 4): one row gather
    t = _decode4(quads, srgb, assume_linear)  # corners 00, 10, 01, 11
    return (
        t[..., 0, :] * (1 - fu) * (1 - fv)
        + t[..., 1, :] * fu * (1 - fv)
        + t[..., 2, :] * (1 - fu) * fv
        + t[..., 3, :] * fu * fv
    )


def sample_bilinear(arena: dict, tex, uv, mip, assume_linear=False):
    """Bilinear sample at integer mip; tex (R,) texture ids, uv (R, 2)."""
    entry = arena["table"][tex.long(), mip.long()]
    return _bilinear_entry(arena, entry, uv, assume_linear)


def sample_trilinear(arena: dict, tex, uv, lod, assume_linear=False):
    """Trilinear sample at fractional lod, clamped to each texture's
    [0, n_mips - 1]."""
    n_mips = arena["n_mips"][tex.long()].to(torch.float32)
    lod = torch.minimum(torch.clamp_min(lod, 0.0), n_mips - 1.0)
    m0 = torch.floor(lod).to(torch.int64)
    m1 = torch.minimum(m0 + 1, (n_mips - 1.0).to(torch.int64))
    f = (lod - m0.to(torch.float32))[..., None]
    s0 = sample_bilinear(arena, tex, uv, m0, assume_linear)
    s1 = sample_bilinear(arena, tex, uv, m1, assume_linear)
    return s0 * (1 - f) + s1 * f


def sample_aniso(arena: dict, tex, uv, duv_major, lod_minor, taps: int,
                 assume_linear=False):
    """Software anisotropic filter (the reference samples materials with
    maxAnisotropy 16, WorldData.cpp:693-714): `taps` trilinear samples
    spread along the uv-space major footprint axis duv_major (R, 2) at
    the minor axis' lod, averaged."""
    assert taps >= 1
    if taps == 1:
        return sample_trilinear(arena, tex, uv, lod_minor, assume_linear)
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear(arena, tex, uv + f * duv_major, lod_minor,
                             assume_linear)
        acc = s if acc is None else acc + s
    return acc / taps


def pack_material_tables(materials: dict, arena: dict):
    """Material SoA + the three textures' mip-0 entries of the numpy
    arena -> numpy
    mat_f32 (M, 8): base_color_factor[4], metallic, roughness, cutoff, 0
    mat_i32 (M, 16): alpha_mode, bc_tex, mr_tex, nrm_tex, bc[4], mr[4],
    nrm[4] entries."""
    bc = np.asarray(materials["base_color_factor"])
    m = len(bc)
    f32 = np.zeros((m, 8), np.float32)
    f32[:, 0:4] = bc
    f32[:, 4] = np.asarray(materials["metallic_factor"])
    f32[:, 5] = np.asarray(materials["roughness_factor"])
    f32[:, 6] = np.asarray(materials["alpha_cutoff"])
    table = np.asarray(arena["table"])
    i32 = np.zeros((m, 16), np.int32)
    i32[:, 0] = np.asarray(materials["alpha_mode"])
    for j, key in enumerate(
        ["base_color_tex", "metallic_roughness_tex", "normal_tex"]
    ):
        tex = np.asarray(materials[key])
        i32[:, 1 + j] = tex
        i32[:, 4 + 4 * j : 8 + 4 * j] = table[tex, 0]
    return f32, i32


def sample_material_packed(arena: dict, mat_idx: torch.Tensor, uv, lod=None,
                           duv_major=None, aniso_taps: int = 1,
                           fixed_mip: int | None = None):
    """sampleMaterial over the packed tables. Returns albedo (R, 3), alpha
    (-1 opaque, 0 failed mask, else blend alpha), roughness, metallic,
    and normal_ts (x == -2 without a normal map).

    lod=None: the base mip (the RT shaders' derivative-free texture()).
    lod given: the per-ray log2 footprint of a unit texture, to which
    each texture adds log2 of its base size (ray-cone mip selection);
    trilinear taps, or with duv_major and aniso_taps > 1 that many along
    the major axis at the minor axis' lod. fixed_mip: every texture at
    one clamped integer mip (config.policy.bounce_tap_mip for secondary
    surfaces)."""
    idx = mat_idx.long()
    f32 = arena["mat_f32"][idx]
    i32 = arena["mat_i32"][idx]

    if fixed_mip is not None:
        def tex_sample(tex_ids, entry0, linear=False):
            mip = torch.clamp_max(arena["n_mips"][tex_ids.long()] - 1,
                                  int(fixed_mip))
            return sample_bilinear(arena, tex_ids, uv, mip,
                                   assume_linear=linear)
    elif lod is None:
        def tex_sample(tex_ids, entry0, linear=False):
            return _bilinear_entry(arena, entry0, uv, assume_linear=linear)
    else:
        def tex_sample(tex_ids, entry0, linear=False):
            size = torch.maximum(entry0[..., 1], entry0[..., 2]).to(
                torch.float32)
            lod_t = lod + torch.log2(torch.clamp_min(size, 1.0))
            if aniso_taps > 1 and duv_major is not None:
                return sample_aniso(arena, tex_ids, uv, duv_major, lod_t,
                                    aniso_taps, assume_linear=linear)
            return sample_trilinear(arena, tex_ids, uv, lod_t,
                                    assume_linear=linear)

    base = tex_sample(i32[..., 1], i32[..., 4:8]) * f32[..., 0:4]
    alpha_mode = i32[..., 0]
    cutoff = f32[..., 6]
    alpha = torch.where(
        alpha_mode == 2,
        base[..., 3],
        torch.where((alpha_mode == 1) & (base[..., 3] < cutoff), 0.0, -1.0),
    )
    # glTF: metallicRoughness and normal maps are always linear
    mr = tex_sample(i32[..., 2], i32[..., 8:12], linear=True)
    roughness = torch.clamp_min(mr[..., 1] * f32[..., 5], 0.05)
    metallic = mr[..., 2] * f32[..., 4]
    nrm = tex_sample(i32[..., 3], i32[..., 12:16], linear=True)
    normal_ts = torch.where(
        (i32[..., 3] > 0)[..., None], nrm[..., :3] * 2.0 - 1.0, -2.0
    )
    return {
        "albedo": base[..., :3],
        "alpha": alpha,
        "roughness": roughness,
        "metallic": metallic,
        "normal_ts": normal_ts,
    }


def sample_alpha_packed(arena: dict, mat_idx: torch.Tensor, uv):
    """sampleAlpha over the packed tables at the base mip
    (materials.glsl:123-147): one quad gather. Returns -1 for an opaque
    material, 0 where a mask material fails its cutoff, else the base
    color's alpha."""
    idx = mat_idx.long()
    f32 = arena["mat_f32"][idx]
    i32 = arena["mat_i32"][idx]
    a = _bilinear_entry(arena, i32[..., 4:8], uv)[..., 3] * f32[..., 3]
    alpha_mode = i32[..., 0]
    return torch.where(
        alpha_mode == 2,
        a,
        torch.where((alpha_mode == 1) & (a < f32[..., 6]), 0.0, -1.0),
    )
