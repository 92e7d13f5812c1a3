"""One ReSTIR DI frame, in plain PyTorch.

After sndels/prosper's restir_di passes and rt/direct_illumination:
primary visibility through each pixel's centre; initial reservoirs of 5
uniform light candidates with streaming RIS (MIS weight 1/M); biased
spatial reuse of 5 neighbours in a 30 px disk (up to 5 tries each, 10%
linear depth and normal dot 0.9, a neighbour in row or column 0
rejected, MIS weight 1 / the neighbours found, the RNG advancing on
valid samples only); one shadow ray (t_min 0.1) to the winning light,
times its unbiased contribution weight. pHat = luminance(irradiance *
BRDF * NoL). Every pass reseeds its RNG with (px, py, frame index).
"""

from __future__ import annotations

import math

import torch

from . import rng
from .shade import brdf_nol, dot, luminance, oct_decode, oct_encode, sample_light, surface
from .trace import trace

CANDIDATES = 5
SAMPLES = 5
RADIUS = 30.0
TRIES = 5
SHADOW_T_MIN = 0.1
GBUFFER_T_MIN = 1e-4


def primary_rays(cam: dict, width: int, height: int, px, py, jitter=None):
    """Pinhole rays through pixel centres (jitter None) or through
    (px, py) + jitter (ray.glsl)."""
    w2c = cam["world_to_camera"]
    c2c = cam["camera_to_clip"]
    aspect = c2c[1, 1] / c2c[0, 0]
    tan_y = 1.0 / c2c[1, 1]
    fx = px.to(torch.float32) + (0.5 if jitter is None else jitter[:, 0])
    fy = py.to(torch.float32) + (0.5 if jitter is None else jitter[:, 1])
    ndx = fx / width * 2.0 - 1.0
    ndy = fy / height * 2.0 - 1.0
    d = (ndx[:, None] * w2c[0, :3] * tan_y * aspect
         + ndy[:, None] * w2c[1, :3] * tan_y - w2c[2, :3])
    d = d / dot(d, d).sqrt()[:, None]
    return cam["eye"].expand(d.shape), d


def pixels(width: int, height: int, device):
    px = torch.arange(width, device=device).repeat(height)
    py = torch.arange(height, device=device).repeat_interleave(width)
    return px, py


def p_hat(sd, s, li):
    l, _, irr = sample_light(sd, li, s["position"])
    return luminance(irr * brdf_nol(l, s))


def initial(sd, s, px, py, frame):
    st = rng.seed(px, py, frame)
    R = px.shape[0]
    dt = sd.dtype
    n = float(sd.n_lights)
    li_out = torch.full((R,), -1, dtype=torch.int64, device=px.device)
    sum_w = torch.zeros(R, dtype=dt, device=px.device)
    keep = torch.zeros_like(sum_w)
    for _ in range(CANDIDATES):
        st, u = rng.draw1(st)
        li = torch.clamp_max((u * n).long(), sd.n_lights - 1)
        ph = p_hat(sd, s, li)
        w = (1.0 / CANDIDATES) * ph * n
        sum_w = sum_w + w
        st, a = rng.draw1(st)
        take = a.to(dt) < w / torch.where(sum_w > 0, sum_w, 1.0)
        li_out = torch.where(take, li, li_out)
        keep = torch.where(take, ph, keep)
    ucw = torch.where(li_out >= 0, sum_w / torch.clamp_min(keep, 1e-20), 0.0)
    return li_out, ucw


def spatial(sd, s, lin, neigh, px, py, width, height, frame):
    st = rng.seed(px, py, frame)
    R = px.shape[0]
    dev = px.device
    dt = sd.dtype
    safe = torch.where(lin != 0, lin, 1.0)
    picks = []
    for _ in range(SAMPLES):
        found = torch.zeros(R, dtype=torch.bool, device=dev)
        li = torch.full((R,), -1, dtype=torch.int64, device=dev)
        ucw = torch.zeros(R, dtype=dt, device=dev)
        for _ in range(TRIES):
            trying = ~found
            st2, u2 = rng.draw2(st)
            st = torch.where(trying[:, None], st2, st)
            r = torch.sqrt(u2[:, 0])
            th = 2.0 * math.pi * u2[:, 1]
            off = (torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
                   * RADIUS * 2.0 - RADIUS).to(torch.int32)
            qx, qy = px + off[:, 0], py + off[:, 1]
            inside = (qx > 0) & (qy > 0) & (qx < width) & (qy < height)
            q = (torch.clamp(qy, 0, height - 1) * width
                 + torch.clamp(qx, 0, width - 1))
            row = neigh[q]
            ok_d = torch.abs(1.0 - row[:, 0] / safe) <= 0.1
            ok_n = dot(oct_decode(row[:, 1:4]), s["normal"].to(torch.float32)) >= 0.9
            ok = trying & inside & ok_d & ok_n
            li = torch.where(ok, row[:, 4].long(), li)
            ucw = torch.where(ok, row[:, 5].to(dt), ucw)
            found = found | ok
        picks.append((torch.where(found, li, -1),
                      torch.where(found, ucw, 0.0), found))
    n_found = sum(f.to(dt) for _, _, f in picks)
    out = torch.full((R,), -1, dtype=torch.int64, device=dev)
    keep = torch.zeros(R, dtype=dt, device=dev)
    sum_w = torch.zeros_like(keep)
    for li, ucw, _ in picks:
        ok = li >= 0
        ph = p_hat(sd, s, torch.clamp_min(li, 0))
        w = torch.where(ok, ph * ucw, 0.0)
        sum_w = sum_w + w
        st2, u = rng.draw1(st)
        st = torch.where(ok[:, None], st2, st)
        take = ok & (u.to(dt) < w / torch.where(sum_w > 0, sum_w, 1.0))
        out = torch.where(take, li, out)
        keep = torch.where(take, ph, keep)
    ucw = torch.where(out >= 0, (1.0 / torch.clamp_min(n_found, 1.0)) * sum_w
                      / torch.clamp_min(keep, 1e-20), 0.0)
    return out, ucw


def render(tris, sd, cam: dict, width: int, height: int, frame: int):
    """One frame's linear colour (H, W, 3) float32 and the number of
    pixels that traced a shadow ray."""
    dev = sd.device
    px, py = pixels(width, height, dev)
    o, d = primary_rays(cam, width, height, px, py)
    t, tri, u, v = trace(tris, o, d, GBUFFER_T_MIN,
                         torch.full_like(o[:, 0], float("inf")), False)
    # the G-buffer's ray cone sets the textures' LOD
    s = surface(sd, o, d, t, tri, u, v,
                cone=2.0 / (cam["camera_to_clip"][1, 1].abs() * height))
    valid = s["valid"]
    up = torch.zeros_like(s["normal"])
    up[:, 2] = 1.0
    s["normal"] = torch.where(valid[:, None], s["normal"], up)
    pos = torch.where(valid[:, None], s["position"], 0.0)
    s["position"] = pos
    # the G-buffer's reverse-z depth, and linear depth from it
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], 1) @ cam["world_to_clip"].T
    w = clip[:, 3]
    ndc_z = clip[:, 2] / torch.clamp_min(w.abs(), 1e-20) * torch.sign(w)
    depth = torch.where(valid, ndc_z, 0.0)
    c2c = cam["camera_to_clip"]
    lin = -c2c[2, 3] / (depth + c2c[2, 2])

    li0, ucw0 = initial(sd, s, px, py, frame)
    li0 = torch.where(valid, li0, -1)
    neigh = torch.cat([lin[:, None], oct_encode(s["normal"].to(torch.float32)),
                       li0.to(torch.float32)[:, None],
                       ucw0.to(torch.float32)[:, None]], 1)
    li1, ucw1 = spatial(sd, s, lin, neigh, px, py, width, height, frame)

    l, dist, irr = sample_light(sd, torch.clamp_min(li1, 0), pos)
    shadow = (li1 >= 0) & (dot(l, s["normal"]) > 0.0) & valid
    occluded = trace(tris, pos, l.to(torch.float32), SHADOW_T_MIN,
                     torch.where(shadow, dist.to(torch.float32), 0.0), True)
    lit = shadow & ~occluded
    color = irr * brdf_nol(l, s) * ucw1[:, None]
    color = torch.where(lit[:, None], color, 0.0).to(torch.float32)
    return color.reshape(height, width, 3), int(shadow.sum())
