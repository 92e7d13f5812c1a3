"""One deferred frame, in plain PyTorch.

After sndels/prosper's deferred path (gbuffer.frag, deferred_shading.comp,
lighting.glsl, draw_list_culler.comp, hiz_downsampler.comp): primary
visibility through each pixel's centre; the G-buffer's surface (the
normal through its signed-octahedron encoding, the view vector from the
stored position to the eye); the sun and the clustered point lights,
unshadowed, as the raster path shades them. A froxel lists the point
lights whose sphere reaches it, in ascending light index, and a pixel
shades the first 128 of them that pass its depth slice's test (the
per-froxel cap, MAX_POINT_INDICES of light_clusters.glsl). Here every
light's radius reaches every corner of the scene's bounds (checked), so
every froxel that holds a surface lists every light and every light
passes the slice test: each pixel shades the first 128 point lights.
The linear colour is summed in float32 over the lights, each light's
term computed in the scene data's dtype.

The frame's count is the meshlets drawn: every cluster without culling.
With culling, the two-phase culler of a camera that stays where it is:
a cluster is drawn when its bounding sphere is not outside a frustum
plane and, from the second frame on, not hidden by the HiZ pyramid
(reverse-z min, half resolution rounded up to powers of two) of the
frame's depth. The first frame has no pyramid; each later frame's
phase 1 tests against the pyramid of the frame before, which a static
camera leaves as this frame's, so phase 2 draws nothing more. The
plates have no cone bounds (both faces are drawn), so no cone test.
The culling runs in the scene data's dtype too.
"""

from __future__ import annotations

import itertools
import math

import torch

from .restir import GBUFFER_T_MIN, pixels, primary_rays
from .shade import brdf_nol, dot, normalize, oct_decode, oct_encode, surface
from .trace import trace

MAX_HIZ_MIPS = 12
FROXEL_CAP = 128  # point lights a froxel shades


def hiz_pyramid(depth: torch.Tensor, width: int, height: int) -> list:
    """(H, W) reverse-z depth -> mips; mip 0 is the min over 2x2 pixels
    of the depth padded with 1.0 (near) to twice a power-of-two size."""
    hw = 1 << math.ceil(math.log2(max(width // 2, 1)))
    hh = 1 << math.ceil(math.log2(max(height // 2, 1)))
    full = torch.ones((hh * 2, hw * 2), dtype=depth.dtype, device=depth.device)
    full[:height, :width] = depth
    mips = [full.reshape(hh, 2, hw, 2).amin((1, 3))]
    while min(mips[-1].shape) > 1 and len(mips) < MAX_HIZ_MIPS:
        h, w = mips[-1].shape
        mips.append(mips[-1].reshape(h // 2, 2, w // 2, 2).amin((1, 3)))
    return mips


def _clip(m, p):
    return torch.cat([p, torch.ones_like(p[:, :1])], 1) @ m.T


def sphere_hidden(center, radius, cam: dict, mips: list, width: int,
                  height: int):
    """isSphereOccluded: the sphere's projected box (Mara and McGuire
    2013) picks the mip where it spans about two texels; the sphere is
    hidden where its nearest depth lies behind the min of the 2x2 texels
    around its centre (texels outside the mip read 1.0, never hiding)."""
    w2c = cam["world_to_camera"]
    cv = center @ w2c[:3, :3].T + w2c[:3, 3]
    cx, cy, cz = cv[:, 0], cv[:, 1], -cv[:, 2]
    r = radius * cam["max_view_scale"]
    valid = cz >= r + cam["near"]
    cz = torch.where(valid, cz, 1.0)
    czr2 = cz * cz - r * r
    vx = torch.sqrt(torch.clamp_min(cx * cx + czr2, 0.0))
    vy = torch.sqrt(torch.clamp_min(cy * cy + czr2, 0.0))
    minx = (vx * cx - cz * r) / (vx * cz + cx * r)
    maxx = (vx * cx + cz * r) / (vx * cz - cx * r)
    miny = (vy * cy - cz * r) / (vy * cz + cy * r)
    maxy = (vy * cy + cz * r) / (vy * cz - cy * r)
    p00 = cam["camera_to_clip"][0, 0]
    p11 = cam["camera_to_clip"][1, 1]
    ext_x = (maxx - minx) * p00 * 0.5
    ext_y = (maxy - miny) * p11 * 0.5
    diameter = torch.sqrt((ext_x * width) ** 2 + (ext_y * height) ** 2)
    n = len(mips)
    level = torch.clamp(torch.floor(torch.log2(torch.clamp_min(diameter, 1e-6))),
                        0, n - 1).long()
    level = torch.where(valid, level, 0)

    w2clip = cam["camera_to_clip"] @ w2c
    toward = normalize(cam["eye"] - center)
    near_pt = _clip(w2clip, center + toward * radius[:, None])
    near_depth = near_pt[:, 2] / near_pt[:, 3]
    cc = _clip(w2clip, center)
    hh, hw = mips[0].shape
    u = (cc[:, 0] / cc[:, 3] * 0.5 + 0.5) * (width / (hw * 2))
    v = (cc[:, 1] / cc[:, 3] * 0.5 + 0.5) * (height / (hh * 2))
    hidden = torch.zeros_like(valid)
    for m, mip in enumerate(mips):
        mh, mw = mip.shape
        sel = valid & (level == m)
        x0 = torch.floor(u * mw - 0.5).long()
        y0 = torch.floor(v * mh - 0.5).long()
        least = torch.ones_like(near_depth)
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < mw) & (y >= 0) & (y < mh)
                z = mip[y.clamp(0, mh - 1), x.clamp(0, mw - 1)]
                least = torch.minimum(least, torch.where(inside, z, 1.0))
        hidden |= sel & (near_depth < least)
    return hidden


def drawn_meshlets(tris, cam: dict, depth, width: int, height: int,
                   frame: int, use_culling: bool,
                   dtype=torch.float32) -> int:
    """The meshlets a frame draws (see the module docstring); the
    culling tests and the pyramid computed in `dtype`."""
    if not use_culling:
        return tris.lo.shape[0]
    if frame > 0 and not torch.equal(cam["prev_world_to_clip"],
                                     cam["world_to_clip"]):
        raise NotImplementedError("the culled count of a moving camera")
    cam = {k: v.to(dtype) if v.is_floating_point() else v
           for k, v in cam.items()}
    lo, hi = tris.lo.to(dtype), tris.hi.to(dtype)
    center = (lo + hi) * 0.5
    radius = dot(hi - center, hi - center).sqrt()
    planes = cam["frustum_planes"]
    dist = center @ planes[:, :3].T + planes[:, 3]
    drawn = ~(dist < -radius[:, None]).any(1)
    if frame > 0:
        drawn &= ~sphere_hidden(center, radius, cam,
                                hiz_pyramid(depth.to(dtype), width, height),
                                width, height)
    return int(drawn.sum())


def froxel_lights(tris, sd) -> int:
    """How many point lights each pixel shades: the first FROXEL_CAP,
    where every light reaches every corner of the scene's bounds."""
    lo, hi = tris.lo.amin(0), tris.hi.amax(0)
    pick = torch.tensor(list(itertools.product((False, True), repeat=3)),
                        device=lo.device)
    corners = torch.where(pick, hi, lo)  # (8, 3)
    pos = sd.point_position.to(torch.float32)
    far = (pos[:, None, :] - corners[None]).norm(dim=-1).amax(1)
    if bool((far > sd.point_radius.to(torch.float32)).any()):
        raise NotImplementedError("point lights that do not reach every "
                                  "surface: the froxel lists")
    return min(FROXEL_CAP, pos.shape[0])


def render(tris, sd, cam: dict, width: int, height: int, frame: int,
           use_culling: bool = False):
    """One frame's linear colour (H, W, 3) float32 and the meshlets it
    draws."""
    dev = sd.a_packed.device
    n_points = froxel_lights(tris, sd)
    px, py = pixels(width, height, dev)
    o, d = primary_rays(cam, width, height, px, py)
    t, tri, u, v = trace(tris, o, d, GBUFFER_T_MIN,
                         torch.full_like(o[:, 0], float("inf")), False)
    s = surface(sd, o, d, t, tri, u, v)
    valid = s["valid"]
    pos = torch.where(valid[:, None], s["position"], 0.0)
    clip = _clip(cam["world_to_clip"], pos)
    depth = torch.where(valid, clip[:, 2] / clip[:, 3], 0.0)
    up = torch.zeros_like(s["normal"])
    up[:, 2] = 1.0
    n = torch.where(valid[:, None], s["normal"], up).to(torch.float32)
    s["normal"] = oct_decode(oct_encode(n)).to(sd.dtype)
    s["view"] = normalize(cam["eye"] - pos).to(sd.dtype)
    s["position"] = pos
    color = (sd.sun_irradiance * brdf_nol(sd.sun_l.expand_as(s["normal"]),
                                          s)).to(torch.float32)
    p = pos.to(sd.dtype)
    for i in range(n_points):
        to = sd.point_position[i] - p
        d2 = dot(to, to)
        dist = torch.sqrt(d2)
        dpr = dist / sd.point_radius[i]
        radial = torch.clamp(1.0 - (dpr * dpr) * (dpr * dpr), 0.0, 1.0)
        irr = sd.point_radiance[i] * (radial / torch.clamp_min(d2, 1e-20))[:, None]
        l = to / torch.clamp_min(dist, 1e-20)[:, None]
        color = color + (irr * brdf_nol(l, s)).to(torch.float32)
    color = torch.where(valid[:, None], color, 0.0)
    count = drawn_meshlets(tris, cam, depth.reshape(height, width), width,
                           height, frame, use_culling, sd.dtype)
    return color.reshape(height, width, 3), count
