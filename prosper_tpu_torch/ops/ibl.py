"""Image-based lighting: cubemaps, the split-sum LUT, irradiance and
prefiltered radiance, and the IBL shading term.

Counterpart of prosper_tpu/ops/ibl.py (the whole module: constants
:37-40, `face_directions` :43, `pack_cubemap_rows` :62, `sample_cubemap`
:80, `procedural_sky` :132, `integrate_specular_brdf` :149,
`sample_irradiance` :179, `_prefilter_mip` :211, `prefilter_radiance`
:231, `sample_prefiltered` :250, `eval_ibl` :265, `build_ibl` :294),
ibl/*.comp and scene/skybox.glsl of the reference.

Cubemaps are (6, S, S, 3) float32 tensors in the reference's face
orientation. The JAX package sums its quadratures one sample at a time
(lax.fori_loop); here a chunk of samples is evaluated at once and summed,
then the chunks in order: the same terms, in another summation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mathx.rng import hammersley
from .brdf import (
    _cross,
    _norm,
    fresnel_zero,
    importance_sample_ibl_trowbridge_reitz,
    saturate,
    schlick_fresnel_with_roughness,
    schlick_trowbridge_reitz,
)

SPECULAR_BRDF_LUT_RES = 512
IRRADIANCE_RES = 64
RADIANCE_RES = 512
MAX_REFLECTION_LOD = 10.0
# samples evaluated together in the quadrature loops
CHUNK = 64


def face_directions(res: int, device="cpu") -> torch.Tensor:
    """(6, S, S, 3) unit directions through the texel centers, the face
    convention of sample_irradiance.comp:24-66."""
    c = np.arange(res, dtype=np.float32) + 0.5
    cy, cx = np.meshgrid(c, c, indexing="ij")
    half = res * 0.5
    full = np.full_like(cx, half)
    faces = [
        np.stack([full, (res - cy) - half, (res - cx) - half], -1),
        np.stack([-full, (res - cy) - half, cx - half], -1),
        np.stack([cx - half, full, cy - half], -1),
        np.stack([cx - half, -full, (res - cy) - half], -1),
        np.stack([cx - half, (res - cy) - half, full], -1),
        np.stack([(res - cx) - half, (res - cy) - half, -full], -1),
    ]
    d = np.stack(faces)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d.astype(np.float32), device=device)


def pack_cubemap_rows(cube: torch.Tensor) -> torch.Tensor:
    """(6, S, S, 3) -> (6 S S, 12) rows: each texel with its clamped +x,
    +y and +xy neighbours, so a bilinear tap is one row gather. Pack once
    per cubemap, outside any per-bounce loop."""
    right = torch.cat([cube[:, :, 1:], cube[:, :, -1:]], dim=2)
    down = torch.cat([cube[:, 1:], cube[:, -1:]], dim=1)
    diag = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    S = cube.shape[1]
    return torch.cat([cube, right, down, diag], dim=-1).reshape(
        6 * S * S, 12).contiguous()


def sample_cubemap(cube: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest-face bilinear fetch along d (..., 3). cube: a (6, S, S, 3)
    map (packed on the fly) or its pack_cubemap_rows rows."""
    if cube.dim() == 2:
        rows = cube
        S = int(round((cube.shape[0] // 6) ** 0.5))
        if 6 * S * S != cube.shape[0]:
            raise ValueError(f"not a packed cubemap: {tuple(cube.shape)}")
    else:
        rows = pack_cubemap_rows(cube)
        S = cube.shape[1]
    ax = torch.abs(d)
    major = torch.argmax(ax, dim=-1, keepdim=True)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    pos = torch.gather(d, -1, major)[..., 0] >= 0
    major = major[..., 0]
    face = major * 2 + torch.where(pos, 0, 1)

    m = torch.clamp_min(torch.gather(ax, -1, major[..., None])[..., 0], 1e-20)
    xn, yn, zn = x / m, y / m, z / m
    # face-local (u, v), the inverse of face_directions' mappings
    u = torch.where(face == 0, -zn, torch.where(
        face == 1, zn, torch.where(face == 5, -xn, xn)))
    v = torch.where(face == 2, zn, torch.where(face == 3, -zn, -yn))

    # clamp-to-edge in continuous coordinates
    uu = torch.clamp((u * 0.5 + 0.5) * S - 0.5, 0.0, S - 1.0)
    vv = torch.clamp((v * 0.5 + 0.5) * S - 0.5, 0.0, S - 1.0)
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fu = (uu - x0)[..., None]
    fv = (vv - y0)[..., None]
    xc = torch.clamp(x0.long(), 0, S - 1)
    yc = torch.clamp(y0.long(), 0, S - 1)
    r = rows[(face * S + yc) * S + xc]
    return (r[..., 0:3] * (1 - fu) * (1 - fv) + r[..., 3:6] * fu * (1 - fv)
            + r[..., 6:9] * (1 - fu) * fv + r[..., 9:12] * fu * fv)


def _fma_dot(d: torch.Tensor, s: np.ndarray) -> torch.Tensor:
    """d (..., 3) . s as XLA's CPU einsum rounds it: fused multiply-adds
    in component order, each float32 product-sum formed exactly in
    float64 and rounded once. The sun's ** 512 magnifies any other
    rounding of the dot 512 times."""
    dd = d.to(torch.float64)
    acc = (dd[..., 0] * float(s[0])).to(torch.float32)
    for k in (1, 2):
        acc = (dd[..., k] * float(s[k]) + acc.to(torch.float64)).to(
            torch.float32)
    return acc


def procedural_sky(res: int = 256, sun_dir=(-1.0, -1.0, -1.0),
                   device="cpu") -> torch.Tensor:
    """A gradient sky, a ground and a sun: the environment of tests and
    demos (the reference's KTX environment maps are not in the repo)."""
    d = face_directions(res, device)
    sd = np.asarray(sun_dir, np.float32)
    sd = (-sd / np.linalg.norm(sd)).astype(np.float32)
    horizon = d.new_tensor([0.6, 0.7, 0.85])
    zenith = d.new_tensor([0.2, 0.35, 0.7])
    t = torch.clamp(d[..., 1:2], 0.0, 1.0)
    sky = horizon * (1 - t) + zenith * t
    ground = d.new_tensor([0.25, 0.22, 0.2]) * (
        0.4 + 0.6 * torch.clamp(-d[..., 1:2], 0, 1))
    base = torch.where(d[..., 1:2] >= 0, sky, ground)
    sun = torch.clamp(_fma_dot(d, sd), 0, 1)
    for _ in range(9):  # ** 512, as repeated squaring
        sun = sun * sun
    return (base + sun[..., None] * d.new_tensor([50.0, 45.0, 40.0])).to(
        torch.float32)


def _chunks(n_samples: int):
    for i0 in range(0, n_samples, CHUNK):
        yield i0, min(n_samples, i0 + CHUNK)


def integrate_specular_brdf(res: int = SPECULAR_BRDF_LUT_RES,
                            n_samples: int = 1024,
                            device="cpu") -> torch.Tensor:
    """(res, res, 2) split-sum LUT; x = NoV, y = roughness."""
    grid = torch.arange(res, dtype=torch.float32, device=device) / res
    R, NoV = torch.meshgrid(grid, grid, indexing="ij")
    alpha = R * R
    V = torch.stack([torch.sqrt(torch.clamp_min(1 - NoV * NoV, 0.0)),
                     torch.zeros_like(NoV), NoV], -1)
    N = torch.zeros_like(V)
    N[..., 2] = 1.0
    ab = torch.zeros((res, res, 2), dtype=torch.float32, device=device)
    for i0, i1 in _chunks(n_samples):
        i = torch.arange(i0, i1, device=device)
        xi = hammersley(i, n_samples)[:, None, None, :]
        H = importance_sample_ibl_trowbridge_reitz(xi, alpha, N[None])
        VoH_raw = (V * H).sum(-1, keepdim=True)
        L = 2.0 * VoH_raw * H - V
        NoL = saturate(L[..., 2])
        NoH = saturate(H[..., 2])
        VoH = saturate(VoH_raw[..., 0])
        G = schlick_trowbridge_reitz(NoL, NoV, alpha)
        g_vis = torch.where(
            NoL > 0, G * VoH / torch.clamp_min(NoH * NoV, 1e-8), 0.0)
        fc = torch.pow(1 - VoH, 5.0)
        ab = ab + torch.stack([(1 - fc) * g_vis, fc * g_vis], -1).sum(0)
    return torch.clamp(ab / n_samples, 0.0, 1.0)


def _basis_up(n: torch.Tensor, axis: int, limit: float, fallback: int):
    """Unit vector `axis` where |n[axis]| < limit, else unit `fallback`."""
    a = torch.zeros_like(n)
    a[..., axis] = 1.0
    b = torch.zeros_like(n)
    b[..., fallback] = 1.0
    return torch.where((torch.abs(n[..., axis]) < limit)[..., None], a, b)


def sample_irradiance(env: torch.Tensor,
                      out_res: int = IRRADIANCE_RES) -> torch.Tensor:
    """(6, out_res, out_res, 3) cosine-convolved irradiance."""
    rows = pack_cubemap_rows(env)
    n = face_directions(out_res, env.device)
    up = _basis_up(n, 1, 0.99, 0)
    right = _cross(up, n)
    right = right / _norm(right)
    up2 = _cross(n, right)
    phi_steps, theta_steps = 128, 64
    total = phi_steps * theta_steps
    acc = torch.zeros_like(n)
    for k0, k1 in _chunks(total):
        k = torch.arange(k0, k1, device=env.device)
        j = (k // phi_steps).to(torch.float32)
        i = (k % phi_steps).to(torch.float32)
        theta = (0.5 * math.pi) * j / theta_steps
        phi = (2.0 * math.pi) * i / phi_steps
        st, ct = torch.sin(theta), torch.cos(theta)
        ts = [st * torch.cos(phi), st * torch.sin(phi), ct]
        sv = (ts[0][:, None, None, None, None] * right
              + ts[1][:, None, None, None, None] * up2
              + ts[2][:, None, None, None, None] * n)
        s = torch.clamp_max(sample_cubemap(rows, sv), 10.0)
        acc = acc + (s * (ct * st)[:, None, None, None, None]).sum(0)
    return math.pi * acc / total


def _prefilter_mip(rows: torch.Tensor, n: torch.Tensor, alpha: float,
                   n_samples: int) -> torch.Tensor:
    color = torch.zeros_like(n)
    weight = torch.zeros(n.shape[:-1], dtype=torch.float32, device=n.device)
    a = torch.full(n.shape[:-1], alpha, dtype=torch.float32, device=n.device)
    for i0, i1 in _chunks(n_samples):
        i = torch.arange(i0, i1, device=n.device)
        xi = hammersley(i, n_samples)[:, None, None, None, :]
        h = importance_sample_ibl_trowbridge_reitz(xi, a, n[None])
        l = 2.0 * (n * h).sum(-1, keepdim=True) * h - n
        nol = saturate((n * l).sum(-1))
        s = torch.clamp_max(sample_cubemap(rows, l), 10.0)
        color = color + (s * nol[..., None]).sum(0)
        weight = weight + nol.sum(0)
    return color / torch.clamp_min(weight[..., None], 1e-4)


def prefilter_radiance(env: torch.Tensor, res: int = 128, n_mips: int = 8,
                       n_samples: int = 256) -> list[torch.Tensor]:
    """(6, res >> m, res >> m, 3) GGX-prefiltered mips (Karis), m < n_mips."""
    rows = pack_cubemap_rows(env)
    mips = []
    for m in range(n_mips):
        r = max(res >> m, 1)
        roughness = m / max(n_mips - 1, 1)
        mips.append(_prefilter_mip(rows, face_directions(r, env.device),
                                   roughness * roughness, n_samples))
    return mips


def sample_prefiltered(mips: list, d: torch.Tensor, lod: torch.Tensor):
    """Trilinear-across-mips prefiltered radiance along d."""
    n = len(mips)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    m0 = torch.floor(lod)
    f = (lod - m0)[..., None]
    out = torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                      device=d.device)
    for m in range(n):
        s = sample_cubemap(mips[m], d)
        sel0 = (m0 == m)[..., None]
        sel1 = (m0 == m - 1)[..., None]
        out = (out + torch.where(sel0, s * (1 - f), 0.0)
               + torch.where(sel1, s * f, 0.0))
    return out


def eval_ibl(surface: dict, ibl: dict) -> torch.Tensor:
    """skybox.glsl evalIBL: split-sum diffuse + specular. surface needs
    albedo, metallic, roughness, NoV, normal_ws and inv_view_ray."""
    f0 = fresnel_zero(surface["albedo"], surface["metallic"])
    NoV = surface["NoV"]
    F = schlick_fresnel_with_roughness(NoV, f0, surface["roughness"])
    kd = (1.0 - F) * (1.0 - surface["metallic"])[..., None]

    diffuse = sample_cubemap(ibl["irradiance"], surface["normal_ws"]) * (
        surface["albedo"])
    r = surface["inv_view_ray"]
    nrm = surface["normal_ws"]
    refl = 2.0 * (r * nrm).sum(-1, keepdim=True) * nrm - r
    n_mips = len(ibl["radiance_mips"])
    lod = torch.clamp(surface["roughness"] * MAX_REFLECTION_LOD, 0.0,
                      n_mips - 1.0)
    prefiltered = sample_prefiltered(ibl["radiance_mips"], refl, lod)

    lut = ibl["brdf_lut"]
    res = lut.shape[0]
    xi = torch.clamp((NoV * res).to(torch.int32), 0, res - 1).long()
    yi = torch.clamp((surface["roughness"] * res).to(torch.int32), 0,
                     res - 1).long()
    env_brdf = lut[yi, xi]
    specular = prefiltered * (F * env_brdf[..., 0:1] + env_brdf[..., 1:2])
    return kd * diffuse + specular


def build_ibl(env: torch.Tensor) -> dict:
    """One-time IBL generation (Renderer.cpp:380-382) on env's device:
    the 512^2 split-sum LUT (1024 samples), the 64^2 irradiance map and
    eight prefiltered radiance mips from 128^2 (256 samples)."""
    return {
        "brdf_lut": integrate_specular_brdf(device=env.device),
        "irradiance": sample_irradiance(env),
        "radiance_mips": prefilter_radiance(env),
    }
