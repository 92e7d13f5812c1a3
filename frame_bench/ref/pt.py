"""One path-traced sample per pixel, in plain PyTorch.

After sndels/prosper's rt/reference main.rgen: a primary ray through the
pixel jittered by the first 2D draw; then per bounce one uniformly
picked light with a shadow ray (t_min 0.1; the pick's draw skipped on a
miss), a one-sample MIS choice between cosine-weighted diffuse and
visible-normal GGX sampling (specular weight 1 on metals, else 0.5),
Russian roulette from the third bounce on (survival at least 5%), and a
bounce ray from the Wächter-Binder offset origin. The ray count is one
primary ray per pixel, every shadow ray and every bounce ray traced.
"""

from __future__ import annotations

import torch

from . import rng
from .restir import pixels, primary_rays
from .shade import (
    PI,
    brdf_nol,
    dot,
    ggx_d,
    normalize,
    sample_light,
    smith_g,
    specular,
    f0_of,
    surface,
)
from .trace import trace

SHADOW_T_MIN = 0.1
ROULETTE_AFTER = 1


def onb(n):
    """Duff et al.'s basis, rows (b1, b2, n)."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    b1 = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], -1)
    b2 = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return torch.stack([b1, b2, n], -2)


def cosine_dir(n, u):
    a = (1.0 - 2.0 * u[:, 0]) * 0.99999
    b = torch.sqrt(1.0 - a * a) * 0.99999
    phi = 2.0 * PI * u[:, 1]
    return normalize(n + torch.stack([b * torch.cos(phi), b * torch.sin(phi), a], -1))


def vndf_sample(ve, alpha, u):
    """Heitz's visible-normal sample in the basis -> light direction."""
    vh = normalize(torch.cat([alpha[:, None] * ve[:, :2], ve[:, 2:3]], -1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    x_axis = torch.zeros_like(vh)
    x_axis[:, 0] = 1.0
    t1 = torch.where((lensq > 0.0)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv,
                                  torch.zeros_like(inv)], -1), x_axis)
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * PI * u[:, 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(1.0 - p1 * p1) + s * p2
    nh = (p1[:, None] * t1 + p2[:, None] * t2
          + torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))[:, None] * vh)
    ne = normalize(torch.cat([alpha[:, None] * nh[:, :2],
                              torch.clamp_min(nh[:, 2:3], 0.0)], -1))
    return -ve - 2.0 * dot(-ve, ne)[:, None] * ne


def vndf_pdf(ve, le, alpha):
    ne = normalize(ve + le)
    NoV = torch.clamp(ve[:, 2], 0.0, 1.0)
    NoL = torch.clamp(le[:, 2], 0.0, 1.0)
    NoH = torch.clamp(ne[:, 2], 0.0, 1.0)
    return (smith_g(NoL, NoV, alpha) * NoV * ggx_d(NoH, alpha) / ve[:, 2]) / (4.0 * NoV)


def offset_origin(p, n):
    """Wächter and Binder's origin offset along n, on the float's bits."""
    n = n.to(torch.float32)
    of_i = (256.0 * n).to(torch.int32)
    bits = p.contiguous().view(torch.int32)
    moved = torch.where(p < 0.0, bits - of_i, bits + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, moved)


def render(tris, sd, cam: dict, width: int, height: int, frame: int,
           max_bounces: int = 3):
    """One frame's linear colour (H, W, 3) float32 and its ray count."""
    dev = sd.device
    dt = sd.dtype
    px, py = pixels(width, height, dev)
    R = px.shape[0]
    st = rng.seed(px, py, frame)
    st, jit = rng.draw2(st)
    o, d = primary_rays(cam, width, height, px, py, jitter=jit)
    t, tri, u, v = trace(tris, o, d, 0.0, torch.full_like(o[:, 0], float("inf")),
                         False)
    color = torch.zeros((R, 3), dtype=dt, device=dev)
    thr = torch.ones_like(color)
    active = tri >= 0
    n_rays = R
    n_lights = float(sd.n_lights)
    for b in range(max_bounces):
        s = surface(sd, o, d, t, tri, u, v)
        ok = s["valid"] & active
        st2, pick = rng.draw1(st)
        st = torch.where(ok[:, None], st2, st)
        li = torch.clamp_max((pick * n_lights).long(), sd.n_lights - 1)
        l, dist, irr = sample_light(sd, li, s["position"])
        shadow = ok & (dot(l, s["normal"]) > 0.0)
        occluded = trace(tris, s["position"], l.to(torch.float32), SHADOW_T_MIN,
                         torch.where(shadow, dist.to(torch.float32), 0.0), True)
        lit = shadow & ~occluded
        direct = thr * irr * n_lights * brdf_nol(l, s)
        color = color + torch.where(lit[:, None], direct, 0.0)
        n_rays += int(shadow.sum())

        st, pick_u = rng.draw1(st)
        st, smp = rng.draw2(st)
        n, view = s["normal"], s["view"]
        spec_w = torch.where(s["metallic"] > 0.999, 1.0, 0.5).to(dt)
        diff_w = 1.0 - spec_w
        diffuse = pick_u.to(dt) < diff_w
        basis = onb(n)
        ve = (basis * view[:, None, :]).sum(-1)
        alpha = s["roughness"] * s["roughness"]
        smp = smp.to(dt)

        rd_d = cosine_dir(n, smp)
        nol_d = torch.clamp(dot(n, rd_d), 0.0, 1.0)
        f_d = s["albedo"] / PI
        pdf_d = nol_d / PI * diff_w

        le = vndf_sample(ve, alpha, smp)
        rd_s = (basis * le[:, :, None]).sum(-2)
        nol_s = torch.clamp(dot(n, rd_s), 0.0, 1.0)
        h = normalize(view + rd_s)
        NoV = torch.clamp(dot(n, view), 0.0, 1.0)
        f_s = specular(nol_s, NoV, torch.clamp(dot(n, h), 0.0, 1.0),
                       torch.clamp(dot(view, h), 0.0, 1.0),
                       f0_of(s["albedo"], s["metallic"]), s["roughness"])
        pdf_s = vndf_pdf(ve, le, alpha) * spec_w

        rd = torch.where(diffuse[:, None], rd_d, rd_s)
        f = torch.where(diffuse[:, None], f_d, f_s)
        nol = torch.where(diffuse, nol_d, nol_s)
        pdf = torch.where(diffuse, pdf_d, pdf_s)
        w = f * (nol / pdf)[:, None]
        w = torch.where((w >= 0.0) & torch.isfinite(w), w, 0.0)
        thr = torch.where(ok[:, None], thr * w, thr)
        if b > ROULETTE_AFTER:
            st, rr = rng.draw1(st)
            kill = rr.to(dt) < torch.clamp_min(1.0 - thr.amax(-1), 0.05)
            active = active & ~kill
        active = active & ok
        o = torch.where(active[:, None], offset_origin(s["position"], n), o)
        d = torch.where(active[:, None], rd.to(torch.float32), d)
        if b + 1 < max_bounces:
            n_rays += int(active.sum())
            t, tri, u, v = trace(tris, o, d, 0.0,
                                 torch.where(active, float("inf"), 0.0), False)
    return color.to(torch.float32).reshape(height, width, 3), n_rays
