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


class SceneData:
    """What shading reads of the raw inputs, on a device: vertex rows,
    corner indices, materials, lights."""

    def __init__(self, inputs: dict, device, dtype=torch.float32):
        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        mats = inputs["materials"]
        if (np.asarray(mats["alpha_mode"]) != 0).any() or any(
                (np.asarray(mats[k]) != 0).any() for k in
                ("base_color_tex", "metallic_roughness_tex", "normal_tex")):
            raise NotImplementedError("the reference shades opaque, "
                                      "untextured materials only")
        self.dtype = dtype
        self.a_packed = t(inputs["a_packed"], torch.float32)
        self.aidx = t(inputs["aidx"], torch.int64)
        self.tri_material = t(inputs["tri_material"], torch.int64)
        self.base_color = t(mats["base_color_factor"])[:, :3]
        # the 1-texel white texture: factors alone; roughness floored at
        # 0.05 (materials.glsl)
        self.roughness = torch.clamp_min(t(mats["roughness_factor"]), 0.05)
        self.metallic = t(mats["metallic_factor"])
        # light 0 is the sun, then the point lights (sampleLight order)
        self.sun_irradiance = t(inputs["sun_irradiance"])
        self.sun_l = -normalize(t(inputs["sun_direction"]))
        self.point_position = t(inputs["point_position"])
        self.point_radiance = t(inputs["point_radiance"])
        self.point_radius = t(inputs["point_radius"])
        self.n_lights = 1 + self.point_position.shape[0]


def surface(sd: SceneData, o, d, t, tri, u, v) -> dict:
    """The visible surface at each hit: position, shading normal (the
    corners' unit normals blended by the barycentrics), material terms;
    `valid` False on a miss."""
    valid = tri >= 0
    tr = torch.clamp_min(tri, 0)
    a = sd.a_packed[sd.aidx[tr]]  # (R, 3 corners, 12)
    n_c = normalize(a[..., 0:3])
    w = 1.0 - u - v
    n = normalize(w[:, None] * n_c[:, 0] + u[:, None] * n_c[:, 1]
                  + v[:, None] * n_c[:, 2])
    mat = sd.tri_material[tr]
    pos = o + torch.where(valid, t, 0.0)[:, None] * d
    dt = sd.dtype
    return {
        "valid": valid,
        "position": pos,
        "normal": n.to(dt),
        "view": (-d).to(dt),
        "albedo": sd.base_color[mat],
        "roughness": sd.roughness[mat],
        "metallic": sd.metallic[mat],
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
    sector = torch.clamp(torch.floor(hue), 0, 5).long()
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
