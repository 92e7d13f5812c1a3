"""PBR BRDF evaluation and importance sampling.

Counterpart of prosper_tpu/ops/brdf.py: every function that
prosper_tpu/render/pt.py imports from it (pt.py:40-51) — `saturate`,
`lambert_brdf`, `cook_torrance_brdf` with `trowbridge_reitz`,
`schlick_fresnel` and `schlick_trowbridge_reitz`, `fresnel_zero`,
`eval_brdf_times_nol`, `orthonormal_basis`, `cosine_sample_hemisphere`,
`cosine_hemisphere_pdf`, `sample_visible_trowbridge_reitz`,
`visible_trowbridge_reitz_pdf` (brdf.glsl:9-88 and sampling.glsl of the
reference), and for ops/ibl.py `schlick_fresnel_with_roughness` (:41) and
`importance_sample_ibl_trowbridge_reitz` (:170). All functions are batched over (..., 3) tensors.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiler import gprofiler

_PI = math.pi


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v, keepdim=True):
    return (v * v).sum(-1, keepdim=keepdim).sqrt()


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lambert_brdf(c_diff):
    return c_diff / _PI


def trowbridge_reitz(NoH, alpha):
    a2 = alpha * alpha
    denom = NoH * NoH * (a2 - 1.0) + 1.0
    return a2 / (_PI * denom * denom)


def schlick_fresnel(VoH, f0):
    return f0 + (1.0 - f0) * torch.pow(1.0 - VoH, 5.0)[..., None]


def schlick_fresnel_with_roughness(VoH, f0, roughness):
    return f0 + (
        torch.maximum((1.0 - roughness)[..., None], f0) - f0
    ) * torch.pow(1.0 - VoH, 5.0)[..., None]


def schlick_trowbridge_reitz(NoL, NoV, alpha):
    k = torch.clamp_min(alpha * 0.5, 1e-4)
    gl = NoL / (NoL * (1.0 - k) + k)
    gv = NoV / (NoV * (1.0 - k) + k)
    return gl * gv


def cook_torrance_brdf(NoL, NoV, NoH, VoH, f0, roughness):
    alpha = roughness * roughness
    D = trowbridge_reitz(NoH, alpha)
    F = schlick_fresnel(VoH, f0)
    G = schlick_trowbridge_reitz(NoL, NoV, alpha)
    denom = 4.0 * NoL * NoV + 1e-4
    return (D * G / denom)[..., None] * F


def fresnel_zero(albedo, metallic):
    """mix(0.04, albedo, metallic) (brdf.glsl:64-68)."""
    return 0.04 * (1.0 - metallic)[..., None] + albedo * metallic[..., None]


def eval_brdf_times_nol(l, view, normal, albedo, roughness, metallic):
    """(lambert + cook-torrance) * NoL (brdf.glsl:70-88); view is the unit
    vector towards the eye."""
    h = l + view
    h = h / torch.clamp_min(_norm(h), 1e-20)
    NoL = saturate(_dot(normal, l))
    NoV = saturate(_dot(normal, view))
    NoH = saturate(_dot(normal, h))
    VoH = saturate(_dot(view, h))
    f0 = fresnel_zero(albedo, metallic)
    c_diff = albedo * (1.0 - 0.04) * (1.0 - metallic)[..., None]
    brdf = lambert_brdf(c_diff) + cook_torrance_brdf(
        NoL, NoV, NoH, VoH, f0, roughness
    )
    return brdf * NoL[..., None]


def orthonormal_basis(n):
    """Duff et al. ONB (sampling.glsl:37-47): (..., 3, 3) with rows
    (b1, b2, n), so basis @ v maps world -> local."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    b1 = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1
    )
    b2 = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return torch.stack([b1, b2, n], dim=-2)


def cosine_sample_hemisphere(n, u):
    """Shirley sphere-tip construction (sampling.glsl:18-33)."""
    a = (1.0 - 2.0 * u[..., 0]) * 0.99999
    b = torch.sqrt(1.0 - a * a) * 0.99999
    phi = 2.0 * _PI * u[..., 1]
    offs = torch.stack([b * torch.cos(phi), b * torch.sin(phi), a], dim=-1)
    d = n + offs
    return d / _norm(d)


def cosine_hemisphere_pdf(NoL):
    return NoL / _PI


def reflect(i, n):
    return i - 2.0 * _dot(i, n)[..., None] * n


def sample_visible_trowbridge_reitz(ve, alpha, us):
    """Heitz VNDF sampling in basis space (sampling.glsl:53-79): view dir
    ve (..., 3) -> light dir."""
    if alpha.dim() == ve.dim() - 1:
        alpha = alpha[..., None]
    vh = torch.cat([alpha * ve[..., :2], ve[..., 2:3]], dim=-1)
    vh = vh / _norm(vh)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    with gprofiler.wait("brdf.vndf_t1"):
        x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype,
                              device=vh.device)
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack(
            [-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], -1
        ),
        x_axis,
    )
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(us[..., 0])
    phi = 2.0 * _PI * us[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(1.0 - p1 * p1) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))[..., None]
        * vh
    )
    ne = torch.cat(
        [alpha * nh[..., :2], torch.clamp_min(nh[..., 2:3], 0.0)], dim=-1
    )
    ne = ne / torch.clamp_min(_norm(ne), 1e-20)
    return reflect(-ve, ne)


def visible_trowbridge_reitz_pdf(ve, le, alpha):
    """VNDF pdf in basis space (sampling.glsl:81-93)."""
    ne = ve + le
    ne = ne / torch.clamp_min(_norm(ne), 1e-20)
    NoV = saturate(ve[..., 2])
    NoL = saturate(le[..., 2])
    NoH = saturate(ne[..., 2])
    vndf = (
        schlick_trowbridge_reitz(NoL, NoV, alpha)
        * NoV
        * trowbridge_reitz(NoH, alpha)
        / ve[..., 2]
    )
    return vndf / (4.0 * NoV)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def importance_sample_ibl_trowbridge_reitz(xi, alpha, n):
    """UE4 split-sum GGX half-vector sampling (sampling.glsl:97-113)."""
    phi = 2.0 * _PI * xi[..., 0]
    cos_t = torch.sqrt(
        (1.0 - xi[..., 1]) / (1.0 + (alpha * alpha - 1.0) * xi[..., 1]))
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    h = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    dim=-1)
    z_up = torch.zeros_like(n)
    z_up[..., 2] = 1.0
    x_up = torch.zeros_like(n)
    x_up[..., 0] = 1.0
    up = torch.where((torch.abs(n[..., 2]) < 0.999)[..., None], z_up, x_up)
    tx = _cross(up, n)
    tx = tx / _norm(tx)
    ty = _cross(n, tx)
    ty = ty / _norm(ty)
    out = tx * h[..., 0:1] + ty * h[..., 1:2] + n * h[..., 2:3]
    return out / _norm(out)
