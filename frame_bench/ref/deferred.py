"""One deferred frame, in plain PyTorch.

After sndels/prosper's deferred path (gbuffer.frag, deferred_shading.comp,
lighting.glsl, light_clustering.comp, light_clusters.glsl,
draw_list_culler.comp, hiz_downsampler.comp): primary visibility
through each pixel's centre over the clusters the culler draws; the
G-buffer's surface (textures at the ray cone's LOD, the normal map, the
normal through its signed-octahedron encoding, the view vector from the
stored position to the eye); the sun and the clustered point lights,
unshadowed, as the raster path shades them. The linear colour is summed
in float32 over the lights, each light's term computed in the scene
data's dtype.

Froxel lists: a froxel (a 32x32 pixel tile by one of 17 logarithmic
depth slices) lists the point lights whose sphere is on the inner side
of each of the tile's four side planes (Gribb-Hartmann planes of the
tile's part of the projection) and overlaps the slice's depth range, in
ascending light index; a pixel shades the first 128 of its froxel's
list (MAX_POINT_INDICES of light_clusters.glsl). A light whose sphere
reaches every surface is in every list, so a scene whose every light
does (the plate's) shades the first 128 point lights everywhere.

The frame's count is the meshlets drawn: every cluster without culling.
With culling, upstream's two-phase culler (draw_list_culler.comp): a
cluster is a candidate when its bounding sphere is not outside a
frustum plane and its normal cone does not face away from the eye.
Phase 1 draws the candidates that the previous frame's HiZ pyramid
(reverse-z min, half resolution rounded up to powers of two, at most 12
mips) does not hide, tested with this frame's camera; a pyramid is made
of phase 1's depth; phase 2 draws the candidates that phase 1 held back
and this pyramid does not hide; the pyramid goes on to the next frame.
The first frame has no pyramid. The G-buffer is the closest hit over
the drawn clusters.

A camera that stays where it is leaves each frame the pyramid of its
own depth, which the reference makes itself (phase 2 then draws
nothing). For a camera that moves, phase 1's pyramid is the previous
frame's phase-1 depth, which depends on the frame before that, and so
on back to the first frame. The reference follows that chain for two
frames: the harness renders the frame before a compared frame with
`pyramid`, starting from the program's pyramid of the frame before
that (the program's state), and hands the pyramid it makes to `render`
as `prev_hiz`; the compared frame's count and image thus rest on the
reference's own pyramid, and the comparison holds both pyramids the
reference makes against the program's (`hiz_off`). The first frame,
which has no pyramid, is worked out from the inputs alone. The culling
runs in the scene data's dtype too.
"""

from __future__ import annotations

import math

import torch

from .restir import GBUFFER_T_MIN, pixels, primary_rays
from .shade import brdf_nol, dot, normalize, oct_decode, oct_encode, surface
from .trace import trace

MAX_HIZ_MIPS = 12
FROXEL_CAP = 128  # point lights a froxel shades
TILE = 32  # a froxel's pixels a side
Z_SLICES = 17


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


def depth_of(cam: dict, o, d, t, tri):
    """Reverse-z depth of each hit (0 on a miss)."""
    valid = tri >= 0
    pos = torch.where(valid[:, None], o + torch.where(valid, t, 0.0)[:, None] * d,
                      0.0)
    clip = _clip(cam["world_to_clip"], pos)
    return torch.where(valid, clip[:, 2] / clip[:, 3], 0.0)


def candidates(tris, cam: dict):
    """The clusters inside the frustum whose normal cone does not face
    away from the eye (meshopt's cone test, draw_list_culler.comp), in
    the camera's dtype."""
    dt = cam["world_to_clip"].dtype
    center, radius = tris.center.to(dt), tris.radius.to(dt)
    planes = cam["frustum_planes"]
    dist = center @ planes[:, :3].T + planes[:, 3]
    inside = ~(dist < -radius[:, None]).any(1)
    to_c = center - cam["eye"]
    away = ((to_c * tris.axis.to(dt)).sum(-1)
            >= tris.cutoff.to(dt) * dot(to_c, to_c).sqrt() + radius)
    return inside & ~away


def _merge(a, b):
    """Closest of two hits (t, tri, u, v); ties keep a."""
    near = b[0] < a[0]
    return tuple(torch.where(near, y, x) for x, y in zip(a, b))


def _culling(tris, cam: dict, dtype):
    """The camera in the culling's dtype, the candidates and a test of
    the clusters' spheres against a pyramid."""
    cc = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in cam.items()}
    center, radius = tris.center.to(dtype), tris.radius.to(dtype)
    return candidates(tris, cc), lambda mips, w, h: sphere_hidden(
        center, radius, cc, mips, w, h)


def _first_phase(tris, cam: dict, o, d, width: int, height: int,
                 frame: int, prev_hiz, dtype):
    """A moving camera's phase 1: the candidates, those the previous
    pyramid hides, the rest, the closest hits over the rest, the pyramid
    of their depth (in `dtype`) and the sphere test."""
    inf = torch.full_like(o[:, 0], float("inf"))
    cand, hidden = _culling(tris, cam, dtype)
    held = (hidden([m.to(dtype) for m in prev_hiz], width, height)
            if frame > 0 and prev_hiz else torch.zeros_like(cand))
    first = cand & ~held
    hit = trace(tris, o, d, GBUFFER_T_MIN, inf, False, groups=first)
    depth = depth_of(cam, o, d, hit[0], hit[1]).reshape(height, width)
    return (cand, held, first, hit,
            hiz_pyramid(depth.to(dtype), width, height), hidden)


def culled_trace(tris, cam: dict, o, d, width: int, height: int,
                 frame: int, prev_hiz=None, dtype=torch.float32):
    """The G-buffer's hits over the clusters the two-phase culler draws
    (see the module docstring), their count, and (a moving camera) the
    pyramid of phase 1's depth; the culling tests and the pyramids in
    `dtype`."""
    inf = torch.full_like(o[:, 0], float("inf"))
    if torch.equal(cam["prev_world_to_clip"], cam["world_to_clip"]):
        cand, hidden = _culling(tris, cam, dtype)
        hit = trace(tris, o, d, GBUFFER_T_MIN, inf, False, groups=cand)
        drawn = cand
        if frame > 0:
            depth = depth_of(cam, o, d, hit[0], hit[1]).reshape(height, width)
            drawn = cand & ~hidden(hiz_pyramid(depth.to(dtype), width, height),
                                   width, height)
            winners = hit[1][hit[1] >= 0] // tris.v0.shape[1]
            if not bool(drawn[winners].all()):
                hit = trace(tris, o, d, GBUFFER_T_MIN, inf, False,
                            groups=drawn)
        return hit, int(drawn.sum()), None
    cand, held, first, hit, fresh, hidden = _first_phase(
        tris, cam, o, d, width, height, frame, prev_hiz, dtype)
    second = cand & held & ~hidden(fresh, width, height)
    if bool(second.any()):
        hit = _merge(hit, trace(tris, o, d, GBUFFER_T_MIN, inf, False,
                                groups=second))
    return hit, int(first.sum() + second.sum()), fresh


def pyramid(tris, sd, cam: dict, width: int, height: int, frame: int,
            prev_hiz=None) -> list:
    """The HiZ pyramid that a moving camera's frame leaves for the next
    (that of its phase-1 depth), from the pyramid it starts from (None:
    the first frame's, none), in the scene data's dtype."""
    px, py = pixels(width, height, sd.device)
    o, d = primary_rays(cam, width, height, px, py)
    return _first_phase(tris, cam, o, d, width, height, frame, prev_hiz,
                        sd.dtype)[4]


def tile_planes(cam: dict, width: int, height: int):
    """The side planes of each froxel column and row (view space, unit
    normals pointing in): (x-, x+) (FX, 4) each and (y-, y+) (FY, 4)
    each, from the projection scaled to the tile grid
    (light_clustering.comp)."""
    c2c = cam["camera_to_clip"].to(torch.float32)
    dev = c2c.device
    fx, fy = -(-width // TILE), -(-height // TILE)
    sx, sy = width / (2.0 * TILE), height / (2.0 * TILE)
    bx = sx - torch.arange(fx, dtype=torch.float32, device=dev)
    by = sy - torch.arange(fy, dtype=torch.float32, device=dev)

    def unit(p):
        return p / torch.sqrt((p[:, :3] * p[:, :3]).sum(-1, keepdim=True))

    zx, zy = torch.zeros_like(bx), torch.zeros_like(by)
    mx = (c2c[0, 0] * sx).expand(fx)
    my = (c2c[1, 1] * sy).expand(fy)
    # -z - row and -z + row of the tile's projection (the view looks down -z)
    return (unit(torch.stack([-mx, zx, bx - 1.0, zx], -1)),
            unit(torch.stack([mx, zx, -bx - 1.0, zx], -1)),
            unit(torch.stack([zy, -my, by - 1.0, zy], -1)),
            unit(torch.stack([zy, my, -by - 1.0, zy], -1)))


def slice_range(z_cam, near, far):
    """The depth range [near_d, far_d] of the Doom slice (of 17, over
    [near, far]) that holds view z (light_clusters.glsl)."""
    lr = torch.log(far / near)
    si = torch.clamp(Z_SLICES * torch.log(torch.clamp_min(-z_cam / near, 1e-20))
                     / lr, 0.0, Z_SLICES - 1).to(torch.int32).to(torch.float32)
    near_d = torch.where(si == 0.0, 0.0, near * torch.exp(si / Z_SLICES * lr))
    far_d = near * torch.exp((si + 1.0) / Z_SLICES * lr)
    return near_d, far_d


def point_lights(sd, s, pos, valid, cam: dict, width: int, height: int, px,
                 py, color):
    """`color` plus the clustered point lights' at each pixel, light by
    light in ascending index: each pixel the first FROXEL_CAP lights of
    its froxel's list (module docstring)."""
    w2c = cam["world_to_camera"].to(torch.float32)
    lpos = sd.point_position.to(torch.float32)
    lr = sd.point_radius.to(torch.float32)
    lv = lpos @ w2c[:3, :3].T + w2c[:3, 3]
    xm, xp, ym, yp = tile_planes(cam, width, height)

    def inside(planes):
        return (lv @ planes[:, :3].T - planes[None, :, 3]) >= -lr[:, None]

    in_x = inside(xm) & inside(xp)  # (L, FX)
    in_y = inside(ym) & inside(yp)  # (L, FY)
    tx, ty = px // TILE, py // TILE
    z_cam = pos @ w2c[2, :3] + w2c[2, 3]
    near_d, far_d = slice_range(z_cam, cam["near"].to(torch.float32),
                                cam["far"].to(torch.float32))
    shaded = torch.zeros_like(z_cam)
    p = pos.to(sd.dtype)
    for i in range(lpos.shape[0]):
        listed = (in_x[i][tx] & in_y[i][ty] & valid
                  & (-lv[i, 2] - near_d >= -lr[i])
                  & (lv[i, 2] + far_d >= -lr[i]))
        take = listed & (shaded < FROXEL_CAP)
        shaded = shaded + listed.to(shaded.dtype)
        if not bool(take.any()):
            if bool((valid & (shaded < FROXEL_CAP)).any()):
                continue
            break
        to = sd.point_position[i] - p
        d2 = dot(to, to)
        dist = torch.sqrt(d2)
        dpr = dist / sd.point_radius[i]
        radial = torch.clamp(1.0 - (dpr * dpr) * (dpr * dpr), 0.0, 1.0)
        irr = sd.point_radiance[i] * (radial / torch.clamp_min(d2, 1e-20))[:, None]
        l = to / torch.clamp_min(dist, 1e-20)[:, None]
        color = color + torch.where(take[:, None],
                                    (irr * brdf_nol(l, s)).to(torch.float32),
                                    0.0)
    return color


def render(tris, sd, cam: dict, width: int, height: int, frame: int,
           use_culling: bool = False, prev_hiz=None):
    """One frame's linear colour (H, W, 3) float32, the meshlets it
    draws, and {"hiz": the pyramid of phase 1's depth} under a moving
    camera with culling (else {})."""
    dev = sd.device
    px, py = pixels(width, height, dev)
    o, d = primary_rays(cam, width, height, px, py)
    extra = {}
    if use_culling:
        (t, tri, u, v), count, fresh = culled_trace(
            tris, cam, o, d, width, height, frame, prev_hiz, sd.dtype)
        if fresh is not None:
            extra["hiz"] = fresh
    else:
        t, tri, u, v = trace(tris, o, d, GBUFFER_T_MIN,
                             torch.full_like(o[:, 0], float("inf")), False)
        count = tris.v0.shape[0]
    cone = 2.0 / (cam["camera_to_clip"][1, 1].abs() * height)
    s = surface(sd, o, d, t, tri, u, v, cone=cone)
    valid = s["valid"]
    pos = torch.where(valid[:, None], s["position"], 0.0)
    up = torch.zeros_like(s["normal"])
    up[:, 2] = 1.0
    n = torch.where(valid[:, None], s["normal"], up).to(torch.float32)
    s["normal"] = oct_decode(oct_encode(n)).to(sd.dtype)
    s["view"] = normalize(cam["eye"] - pos).to(sd.dtype)
    s["position"] = pos
    color = (sd.sun_irradiance * brdf_nol(sd.sun_l.expand_as(s["normal"]),
                                          s)).to(torch.float32)
    color = point_lights(sd, s, pos, valid, cam, width, height, px, py, color)
    color = torch.where(valid[:, None], color, 0.0)
    return color.reshape(height, width, 3), count, extra
