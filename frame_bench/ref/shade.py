"""Surfaces, lights, the BRDF and the display transform, in plain PyTorch.

After sndels/prosper's shaders (visible_surface.glsl, lighting.glsl,
brdf.glsl, sampling.glsl, tone_map.comp). Shading runs in `dtype`
(float32; bfloat16 for the lower-precision control); positions and ray
directions handed to the tracer stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
LUT_DIMS = 48


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.clamp_min(dot(v, v).sqrt(), 1e-20)[..., None]


def srgb_to_linear(x):
    """The sRGB transfer function's inverse (texels read as sRGB)."""
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def mip_chain(pixels: np.ndarray, srgb: bool) -> list[np.ndarray]:
    """(H, W, 4) uint8 -> its mips down to a side of 1, each the 2x2 box
    mean of the one above in linear space (alpha linear) stored back as
    uint8, rounded half up (upstream makes the chain on the CPU,
    Texture.cpp:166-298, and compresses it to BC7; the program keeps
    RGBA8, as this does)."""
    def to_srgb8(x):
        y = np.where(x <= 0.0031308, x * 12.92,
                     1.055 * np.maximum(x, 1e-12) ** (1 / 2.4) - 0.055)
        return np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)

    mips = [pixels]
    f = pixels.astype(np.float32) / 255.0
    if srgb:
        rgb = f[..., :3]
        f = np.concatenate([np.where(rgb <= 0.04045, rgb / 12.92,
                                     ((rgb + 0.055) / 1.055) ** 2.4),
                            f[..., 3:]], -1)
    while min(f.shape[0], f.shape[1]) > 1:
        h, w = f.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        f = f[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
        if srgb:
            m8 = np.concatenate([to_srgb8(f[..., :3]), np.clip(
                f[..., 3:] * 255.0 + 0.5, 0, 255).astype(np.uint8)], -1)
        else:
            m8 = np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
        mips.append(m8)
    return mips


class Texture:
    """One image's mips on a device, as linear RGBA float32 texels
    (sRGB decoded texel by texel, before any filter, as an sRGB view
    reads them), sampled with REPEAT wrap."""

    MAX_MIPS = 13

    def __init__(self, image: dict, device):
        px = np.asarray(image["pixels"], np.uint8)
        if px.ndim != 3 or px.shape[2] != 4 or max(px.shape[:2]) > 2048:
            raise NotImplementedError("textures are RGBA8 of at most 2048 "
                                      "texels a side")
        wrap = tuple(image.get("wrap", (10497, 10497)))
        if wrap != (10497, 10497):
            raise NotImplementedError("textures wrap with REPEAT only")
        self.mips = []
        for m in mip_chain(px, bool(image["srgb"]))[: self.MAX_MIPS]:
            t = torch.as_tensor(m, device=device).to(torch.float32) / 255.0
            if image["srgb"]:
                t = torch.cat([srgb_to_linear(t[..., :3]), t[..., 3:]], -1)
            self.mips.append(t)
        self.log2_size = float(torch.log2(torch.tensor(
            float(max(px.shape[:2])), dtype=torch.float32)))

    def bilinear(self, m: int, uv):
        """A bilinear tap of mip m at uv (R, 2) -> (R, 4)."""
        tex = self.mips[m]
        h, w = tex.shape[:2]

        def axis(s, n):
            c = s * float(n) - 0.5
            c0 = torch.floor(c)
            i = torch.remainder(c0.long(), n)
            return i, torch.remainder(i + 1, n), (c - c0)[:, None]

        x0, x1, fu = axis(uv[:, 0], w)
        y0, y1, fv = axis(uv[:, 1], h)
        return (tex[y0, x0] * (1 - fu) * (1 - fv) + tex[y0, x1] * fu * (1 - fv)
                + tex[y1, x0] * (1 - fu) * fv + tex[y1, x1] * fu * fv)

    def taps(self, mip, uv):
        """Bilinear taps of each row's mip (R,) at uv (R, 2) -> (R, 4)."""
        out = torch.empty((uv.shape[0], 4), dtype=torch.float32,
                          device=uv.device)
        for m in torch.unique(mip).tolist():
            sel = (mip == m).nonzero().squeeze(1)
            out[sel] = self.bilinear(m, uv[sel])
        return out

    def sample(self, uv, lod=None):
        """Trilinear at lod (R,), log2 of the footprint in texels of a
        unit texture (this texture adds log2 of its size), clamped to
        its mips; the base mip's bilinear tap without a lod."""
        if lod is None:
            return self.bilinear(0, uv)
        top = len(self.mips) - 1
        lod = torch.clamp(lod + self.log2_size, 0.0, float(top))
        m0 = torch.floor(lod).long()
        m1 = torch.clamp_max(m0 + 1, top)
        f = (lod - m0.to(torch.float32))[:, None]
        return self.taps(m0, uv) * (1 - f) + self.taps(m1, uv) * f


class SceneData:
    """What shading reads of the inputs, on a device: each slot's corner
    attributes, material and LOD term (trace.scene_slots), materials and
    their textures, lights.

    Materials: base colour factor times the base colour texture (sRGB),
    roughness factor times the metallic-roughness texture's G (floored
    at 0.05, materials.glsl), metallic factor times its B, and a
    tangent-space normal map. A material without a texture takes the
    factor alone (upstream's default texture, a white texel). The glTF
    form's texture indices name its `images` (-1: none); the plate form
    has no textures."""

    def __init__(self, inputs: dict, slots: dict, device,
                 dtype=torch.float32):
        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        mats = inputs["materials"]
        if (np.asarray(mats["alpha_mode"]) != 0).any():
            raise NotImplementedError("the reference shades opaque "
                                      "materials only")
        if "spot_position" in inputs and len(inputs["spot_position"]):
            raise NotImplementedError("the reference shades point lights "
                                      "and the sun only")
        self.dtype = dtype
        self.device = torch.device(device)
        keys = ("base_color_tex", "metallic_roughness_tex", "normal_tex")
        if "gltf" in inputs:
            self.textures = [Texture(im, device) for im in inputs["images"]]
            self.tex_index = {k: [int(i) for i in np.asarray(mats[k])]
                              for k in keys}
        else:  # the plate form: every material untextured
            if any((np.asarray(mats[k]) != 0).any() for k in keys):
                raise NotImplementedError("the plate form's materials are "
                                          "untextured")
            self.textures = []
            self.tex_index = {k: [-1] * len(np.asarray(mats[k])) for k in keys}
        self.corner_normal = t(slots["corner_normal"], torch.float32)
        self.corner_tangent = t(slots["corner_tangent"], torch.float32)
        self.corner_uv = t(slots["corner_uv"], torch.float32)
        self.tri_lod = t(slots["tri_lod"], torch.float32)
        self.tri_material = t(slots["material"], torch.int64)
        self.base_color = t(mats["base_color_factor"])[:, :3]
        self.roughness_factor = t(mats["roughness_factor"])
        self.metallic = t(mats["metallic_factor"])
        # with the white texel: factors alone; roughness floored at 0.05
        self.roughness = torch.clamp_min(self.roughness_factor, 0.05)
        # light 0 is the sun, then the point lights (sampleLight order)
        self.sun_irradiance = t(inputs["sun_irradiance"])
        self.sun_l = -normalize(t(inputs["sun_direction"]))
        self.point_position = t(inputs["point_position"])
        self.point_radiance = t(inputs["point_radiance"])
        self.point_radius = t(inputs["point_radius"])
        self.n_lights = 1 + self.point_position.shape[0]

    @property
    def textured(self) -> bool:
        return any(i >= 0 for v in self.tex_index.values() for i in v)


def mapped_normal(normal_ts, n, tangent, sign):
    """A tangent-space normal -> world: its x along the tangent, y along
    sign * cross(n, tangent), z along n (main.rgen:37-45)."""
    b = sign[:, None] * torch.linalg.cross(n, tangent)
    return normalize(normal_ts[:, 0:1] * tangent + normal_ts[:, 1:2] * b
                     + normal_ts[:, 2:3] * n)


def _materials(sd: SceneData, mat, uv, lod):
    """Albedo, roughness, metallic and the tangent-space normal (None
    where no material has a normal map) at each hit, sampled at the ray
    cone's lod (None: the base mip)."""
    dt = sd.dtype
    albedo = sd.base_color[mat]
    roughness = sd.roughness[mat]
    metallic = sd.metallic[mat]
    normal_ts, has_map = None, None
    if not sd.textured:
        return albedo, roughness, metallic, normal_ts, has_map
    mr = torch.ones((mat.shape[0], 4), dtype=torch.float32, device=uv.device)
    bc = torch.ones_like(mr)
    nrm = torch.zeros_like(mr)
    has_map = torch.zeros_like(mat, dtype=torch.bool)
    for key, out in (("base_color_tex", bc), ("metallic_roughness_tex", mr),
                     ("normal_tex", nrm)):
        for m, ti in enumerate(sd.tex_index[key]):
            sel = (mat == m).nonzero().squeeze(1)
            if ti < 0 or sel.numel() == 0:
                continue
            out[sel] = sd.textures[ti].sample(
                uv[sel], None if lod is None else lod[sel])
            if key == "normal_tex":
                has_map[sel] = True
    albedo = torch.where(_textured(sd, "base_color_tex", mat)[:, None],
                         bc[:, :3].to(dt) * albedo, albedo)
    mr_on = _textured(sd, "metallic_roughness_tex", mat)
    roughness = torch.where(mr_on, torch.clamp_min(
        mr[:, 1].to(dt) * sd.roughness_factor[mat], 0.05), roughness)
    metallic = torch.where(mr_on, mr[:, 2].to(dt) * metallic, metallic)
    normal_ts = nrm[:, :3] * 2.0 - 1.0
    return albedo, roughness, metallic, normal_ts, has_map


def _textured(sd: SceneData, key: str, mat):
    on = torch.tensor([i >= 0 for i in sd.tex_index[key]], device=mat.device)
    return on[mat]


def surface(sd: SceneData, o, d, t, tri, u, v, cone=None) -> dict:
    """The visible surface at each hit: position, shading normal (the
    corners' unit normals blended by the barycentrics, then the normal
    map along the blended tangent frame), material terms; `valid` False
    on a miss. cone: the pixel's spread angle, which sets the textures'
    LOD as the G-buffer's ray cone does (render/surface.py cone_lod: the
    triangle's LOD term plus log2(t * spread / max(|cos|, 0.05)), a
    departure from the raster's screen-space derivatives); None: the
    base mip, as the ray-traced shaders' texture() reads it."""
    valid = tri >= 0
    tr = torch.clamp_min(tri, 0)
    n_c = normalize(sd.corner_normal[tr])  # (R, 3 corners, 3)
    w = 1.0 - u - v
    n = normalize(w[:, None] * n_c[:, 0] + u[:, None] * n_c[:, 1]
                  + v[:, None] * n_c[:, 2])
    mat = sd.tri_material[tr]
    pos = o + torch.where(valid, t, 0.0)[:, None] * d
    dt = sd.dtype
    lod = None
    if sd.textured:
        uv_c = sd.corner_uv[tr]
        uv = w[:, None] * uv_c[:, 0] + u[:, None] * uv_c[:, 1] + v[:, None] * uv_c[:, 2]
        if cone is not None:
            t_hit = torch.where(torch.isfinite(t), t, 0.0)
            cosd = dot(d, n).abs()
            lod = sd.tri_lod[tr] + torch.log2(
                torch.clamp_min(t_hit, 1e-6) * cone / torch.clamp_min(cosd, 0.05))
    else:
        uv = None
    albedo, roughness, metallic, normal_ts, has_map = _materials(
        sd, mat, uv, lod)
    if normal_ts is not None:
        t_c = sd.corner_tangent[tr]
        t_c = torch.cat([normalize(t_c[..., :3]), t_c[..., 3:]], -1)
        tan = (w[:, None] * t_c[:, 0] + u[:, None] * t_c[:, 1]
               + v[:, None] * t_c[:, 2])
        mapped = mapped_normal(normal_ts, n, normalize(tan[:, :3]), tan[:, 3])
        sign = tan[:, 3]
        n = torch.where((has_map & (sign != 0.0))[:, None], mapped, n)
    return {
        "valid": valid,
        "position": pos,
        "normal": n.to(dt),
        "view": (-d).to(dt),
        "albedo": albedo,
        "roughness": roughness,
        "metallic": metallic,
    }


def sample_light(sd: SceneData, li, pos):
    """(l, distance, irradiance) of light li (0: the sun) at pos."""
    dt = sd.dtype
    is_sun = li == 0
    pi = torch.clamp_min(li - 1, 0)
    to = sd.point_position[pi] - pos.to(dt)
    d2 = dot(to, to)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    pl = to / dist[:, None]
    dpr = dist / torch.clamp_min(sd.point_radius[pi], 1e-20)
    radial = torch.clamp(1.0 - (dpr * dpr) * (dpr * dpr), 0.0, 1.0)
    p_irr = sd.point_radiance[pi] * (radial / torch.clamp_min(d2, 1e-20))[:, None]
    l = torch.where(is_sun[:, None], sd.sun_l.expand_as(pl), pl)
    dist = torch.where(is_sun, torch.full_like(dist, 100.0), dist)
    irr = torch.where(is_sun[:, None], sd.sun_irradiance.expand_as(p_irr),
                      p_irr)
    return l, dist, irr


def ggx_d(NoH, alpha):
    a2 = alpha * alpha
    den = NoH * NoH * (a2 - 1.0) + 1.0
    return a2 / (PI * den * den)


def smith_g(NoL, NoV, alpha):
    k = torch.clamp_min(alpha * 0.5, 1e-4)
    return (NoL / (NoL * (1.0 - k) + k)) * (NoV / (NoV * (1.0 - k) + k))


def f0_of(albedo, metallic):
    return 0.04 * (1.0 - metallic)[:, None] + albedo * metallic[:, None]


def specular(NoL, NoV, NoH, VoH, f0, roughness):
    alpha = roughness * roughness
    fres = f0 + (1.0 - f0) * torch.pow(1.0 - VoH, 5.0)[:, None]
    return (ggx_d(NoH, alpha) * smith_g(NoL, NoV, alpha)
            / (4.0 * NoL * NoV + 1e-4))[:, None] * fres


def brdf_nol(l, s: dict):
    """(Lambert + Cook-Torrance) * NoL toward unit l."""
    n, view = s["normal"], s["view"]
    h = normalize(l + view)
    NoL = torch.clamp(dot(n, l), 0.0, 1.0)
    NoV = torch.clamp(dot(n, view), 0.0, 1.0)
    NoH = torch.clamp(dot(n, h), 0.0, 1.0)
    VoH = torch.clamp(dot(view, h), 0.0, 1.0)
    albedo, metallic = s["albedo"], s["metallic"]
    diffuse = albedo * (1.0 - 0.04) * (1.0 - metallic)[:, None] / PI
    spec = specular(NoL, NoV, NoH, VoH, f0_of(albedo, metallic),
                    s["roughness"])
    return (diffuse + spec) * NoL[:, None]


def luminance(c):
    return c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114


def oct_encode(n):
    """The G-buffer's signed-octahedron normal (gbuffer.frag)."""
    n = n / torch.clamp_min(n.abs().sum(-1), 1e-20)[..., None]
    y = n[..., 1] * 0.5 + 0.5
    x = n[..., 0] * 0.5 + y
    y = n[..., 0] * -0.5 + y
    z = torch.clamp(n[..., 2] * 3.40282e38, 0.0, 1.0)
    return torch.stack([x, y, z], -1)


def oct_decode(e):
    nx = e[..., 0] - e[..., 1]
    ny = e[..., 0] + e[..., 1] - 1.0
    nz = (e[..., 2] * 2.0 - 1.0) * (1.0 - nx.abs() - ny.abs())
    return normalize(torch.stack([nx, ny, nz], -1))


def display_lut() -> np.ndarray:
    """The display LUT the renderer uses without the Tony McMapface file:
    each channel a soft shoulder of its own coordinate, mixed slightly
    across channels, (48, 48, 48, 3) indexed [z][y][x]."""
    c = (np.arange(LUT_DIMS, dtype=np.float32) + 0.5) / LUT_DIMS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    rgb = np.stack([x, y, z], axis=-1)
    mixed = 0.9 * rgb + 0.1 * rgb.mean(axis=-1, keepdims=True)
    return (mixed * (1.5 - 0.5 * mixed)).astype(np.float32)


def _contrast(c: torch.Tensor, contrast: float = 1.0) -> torch.Tensor:
    """tone_map.comp's contrast: the HSV value raised to `contrast` after
    a clamp at 0, hue and saturation kept (math.glsl's HSV, hue in
    [0, 6))."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    chroma = v - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(chroma == 0.0, 1.0, chroma)
    hue = torch.where(v == r, torch.remainder((g - b) / safe, 6.0),
                      torch.where(v == g, (b - r) / safe + 2.0,
                                  (r - g) / safe + 4.0))
    hue = torch.where(chroma == 0.0, 0.0, hue)
    sat = torch.where(v == 0.0, 0.0, chroma / torch.where(v == 0.0, 1.0, v))
    v = torch.pow(torch.clamp_min(v, 0.0), contrast)
    chroma = v * sat
    x = chroma * (1.0 - torch.abs(torch.remainder(hue, 2.0) - 1.0))
    z = torch.zeros_like(x)
    # a NaN hue (a colour that is not finite) takes sector 0
    sector = torch.clamp(torch.nan_to_num(torch.floor(hue)), 0, 5).long()
    table = torch.stack([
        torch.stack([chroma, x, z], -1), torch.stack([x, chroma, z], -1),
        torch.stack([z, chroma, x], -1), torch.stack([z, x, chroma], -1),
        torch.stack([x, z, chroma], -1), torch.stack([chroma, z, x], -1)], -2)
    rgb = torch.gather(table, -2, sector[..., None, None].expand(
        *sector.shape, 1, 3)).squeeze(-2)
    return rgb + (v - chroma)[..., None]


def tone_map(color: torch.Tensor, lut: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """Linear HDR (..., 3) -> display (tone_map.comp, exposure and
    contrast 1): the contrast step, x / (x + 1) onto the LUT's texel
    centres, a trilinear tap, gamma 1 / 2.2; computed in `dtype`,
    returned as float32."""
    lut = lut.to(dtype)
    x = _contrast(color.to(dtype))
    enc = x / (x + 1.0)
    c = (enc * ((LUT_DIMS - 1.0) / LUT_DIMS) + 0.5 / LUT_DIMS) * LUT_DIMS - 0.5
    c0 = torch.floor(c)
    f = c - c0
    i0 = torch.clamp(c0.long(), 0, LUT_DIMS - 1)
    i1 = torch.clamp(i0 + 1, 0, LUT_DIMS - 1)
    out = 0.0
    for bz in (0, 1):
        iz = i1[..., 2] if bz else i0[..., 2]
        wz = f[..., 2] if bz else 1.0 - f[..., 2]
        for by in (0, 1):
            iy = i1[..., 1] if by else i0[..., 1]
            wy = f[..., 1] if by else 1.0 - f[..., 1]
            for bx in (0, 1):
                ix = i1[..., 0] if bx else i0[..., 0]
                wx = f[..., 0] if bx else 1.0 - f[..., 0]
                out = out + lut[iz, iy, ix] * (wz * wy * wx)[..., None]
    return torch.pow(torch.clamp_min(out, 0.0), 1.0 / 2.2).to(torch.float32)
