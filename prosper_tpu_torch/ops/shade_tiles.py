"""Clustered point and spot shading per 32x32 froxel tile.

Counterpart of prosper_tpu/ops/shade_tiles.py: `build_tile_light_lists`
(:109) and `shade_clustered_tiles` (:351), whose Pallas kernel
`_shade_kernel` (:175) is replaced by the hand-written CUDA kernel
`shade_kernel` in csrc/shade_tiles.cu (K5), with a plain PyTorch twin.

What the kernel and its plain version compute, per pixel (as
`_shade_kernel` does):
- the Doom z-slice of the pixel's view z (light_clusters.glsl:26-50);
- for each point light of the tile's list, in ascending light order, the
  z-slab test against that slice; a running count of the *visible*
  lights, of which only the first 128 are shaded (the reference's
  per-froxel cap);
- every spot light up to 128 (the reference's isSpotVisible returns
  true);
- the BRDF of brdf.glsl:70-88 times the light's irradiance;
- zero for a pixel without a surface.

Layout: the TPU kernel's (T, 16, 8, 128) tile relayout is a TPU device
and is not carried. The G-buffer comes in as 13 channel planes (13, R),
each in row-major pixel order: position3 | normal3 | albedo3 |
roughness | metallic | z_cam | valid; the result is (R, 3).

`shade_walk_counts` is K5's measurement form (`shade_walk_kernel`,
which chip_smoke.py alone calls; no frame selects it): the same walk
without the shading, giving per pixel the point lights it shades, the
list entries its warp walks before the warp exit and its warp's shading
union (the entries at which some lane of the warp shades); a warp is 32
consecutive pixels of one tile row.

Dispatch: each wrapper runs its plain version only because its tensors
lie on the CPU; on CUDA tensors it launches the kernel or raises, and
counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.profiler import gprofiler
from .clustering import (
    LIGHT_CLUSTER_DIMENSION,
    MAX_POINT_INDICES,
    Z_SLICE_COUNT,
    cluster_index_z,
)

TILE_PX = LIGHT_CLUSTER_DIMENSION  # 32
CHANNELS = 13
MAX_FROXEL_LIGHTS = MAX_POINT_INDICES  # 128
# list entries one staging pass of the kernel holds (csrc MAX_STAGE)
MAX_STAGE = 232448 // 32
_PI = math.pi
# divisions by constants are written as products with the reciprocal,
# which is how PyTorch's CUDA division by a scalar rounds, so that the
# plain version and the kernel round alike on the card
_INV_PI = 1.0 / math.pi
_INV_Z = 1.0 / Z_SLICE_COUNT


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return _cdiv(width, TILE_PX), _cdiv(height, TILE_PX)


def build_tile_light_lists(cam: dict, lights: dict, width: int, height: int,
                           y_offset: int = 0, full_height: int | None = None):
    """Per-tile point-light lists from the froxel side-plane tests
    (light_clustering.comp:67-99), the z test left to the kernel.

    Returns (lists (T, LCAP) i32, counts (T,) i32, light_vz (LCAP,) f32)
    with T in (ty, tx) row-major order: each list holds the visible
    lights in ascending index order, then the others; counts the visible
    ones; light_vz each light's view-space z. All on the camera's
    device, with no host wait.

    y_offset, full_height: the tiles of a band of `height` rows from
    absolute row y_offset (a multiple of the 32 px tile) of a
    full_height frame; the froxel planes are the full frame's, so the
    band's lists are the full frame's rows of tiles. The kernel reads
    them as any frame's lists."""
    if y_offset % TILE_PX:
        raise ValueError(f"y_offset must be a multiple of {TILE_PX}, got "
                         f"{y_offset}")
    full_h = height if full_height is None else full_height
    fx, fy = tile_grid(width, height)
    c2c = cam["camera_to_clip"]
    w2c = cam["world_to_camera"]
    dev = c2c.device
    f32 = torch.float32

    # Python scalars, not tensors from lists: those are host-to-device
    # copies, which wait for the device (the sizes are exact in float32)
    scale_x, scale_y = width / (2.0 * TILE_PX), full_h / (2.0 * TILE_PX)
    cx = torch.arange(fx, dtype=f32, device=dev)
    # absolute froxel rows
    cy = torch.arange(fy, dtype=f32, device=dev) + y_offset // TILE_PX
    bias_x = scale_x - cx
    bias_y = scale_y - cy
    m00 = c2c[0, 0] * scale_x
    m11 = c2c[1, 1] * scale_y

    def norm_plane(p):
        return p / torch.sqrt((p[..., :3] * p[..., :3]).sum(-1, keepdim=True))

    zeros_x = torch.zeros_like(bias_x)
    c1 = torch.stack([m00.expand(fx), zeros_x, -bias_x, zeros_x], -1)
    zeros_y = torch.zeros_like(bias_y)
    c2 = torch.stack([zeros_y, m11.expand(fy), -bias_y, zeros_y], -1)
    c4 = torch.zeros(4, dtype=f32, device=dev)
    with gprofiler.wait("shade_tiles.plane_c4"):  # the -1.0 goes up
        c4[2] = -1.0
    plane_xm = norm_plane(c4[None] - c1)
    plane_xp = norm_plane(c4[None] + c1)
    plane_ym = norm_plane(c4[None] - c2)
    plane_yp = norm_plane(c4[None] + c2)

    pos_vs = lights["point_position"] @ w2c[:3, :3].T + w2c[:3, 3]
    r = lights["point_radius"][:, None]
    n_l = pos_vs.shape[0]

    def side(plane):
        return pos_vs @ plane[:, :3].T - plane[None, :, 3]

    vx = (side(plane_xm) >= -r) & (side(plane_xp) >= -r)  # (L, FX)
    vy = (side(plane_ym) >= -r) & (side(plane_yp) >= -r)  # (L, FY)
    in_range = torch.arange(n_l, device=dev) < lights["point_count"]
    vis = (
        vy.T[:, None, :] & vx.T[None, :, :] & in_range[None, None, :]
    ).reshape(fy * fx, n_l)
    counts = vis.sum(dim=-1).to(torch.int32)
    # ascending light index among the visible ones, then the rest
    order = torch.sort((~vis).to(torch.uint8), dim=-1, stable=True).indices
    lcap = _cdiv(n_l, 128) * 128
    lists = torch.zeros((fy * fx, lcap), dtype=torch.int32, device=dev)
    lists[:, :n_l] = order[:, :lcap].to(torch.int32)
    vz = torch.zeros(lcap, dtype=f32, device=dev)
    vz[:n_l] = pos_vs[:, 2]
    return lists, counts, vz


def tile_inputs(surface: dict, lights: dict, cam: dict, z_cam, valid,
                width: int, height: int, light_lists=None, y_offset: int = 0,
                full_height: int | None = None) -> dict:
    """The kernel's inputs from a shading surface and the frame's lights:
    chan (13, R) G-buffer planes, rows (1 + P + S, 12) packed light rows,
    the tile lists (light_lists, build_tile_light_lists' output, when the
    caller made them, else made here for the band y_offset, full_height),
    ints (2,) i32 [point_count, min(spot_count, 128)], scal (8,) f32
    [near, far, log(far / near), eye.xyz, 0, 0]."""
    lists, counts, lvz = light_lists or build_tile_light_lists(
        cam, lights, width, height, y_offset, full_height)
    pos, n, alb = surface["position_ws"], surface["normal_ws"], surface["albedo"]
    chan = torch.stack([
        pos[:, 0], pos[:, 1], pos[:, 2], n[:, 0], n[:, 1], n[:, 2],
        alb[:, 0], alb[:, 1], alb[:, 2], surface["roughness"],
        surface["metallic"], z_cam, valid.to(torch.float32),
    ]).contiguous()
    ints = torch.stack([
        lights["point_count"].to(torch.int32).reshape(()),
        torch.clamp_max(lights["spot_count"], MAX_FROXEL_LIGHTS).to(
            torch.int32).reshape(()),
    ])
    near, far = cam["near"].reshape(1), cam["far"].reshape(1)
    scal = torch.cat([near, far, torch.log(far / near), cam["eye"],
                      torch.zeros(2, dtype=torch.float32, device=near.device)])
    return {"chan": chan, "rows": lights["packed_rows"].contiguous(),
            "lists": lists, "counts": counts, "lvz": lvz, "ints": ints,
            "scal": scal.contiguous()}


def _light_contrib(l, iv, n, NoV, f0, cd, a2, k, gv):
    """brdf.glsl:70-88 for unit light directions l (3 planes) -> the
    three channels of brdf * NoL, as _shade_kernel's light_contrib
    (shade_tiles.py:241-264), operation for operation with the kernel."""
    hx, hy, hz = l[0] + iv[0], l[1] + iv[1], l[2] + iv[2]
    hil = 1.0 / torch.sqrt(torch.clamp_min(hx * hx + hy * hy + hz * hz,
                                           1e-40))
    hx, hy, hz = hx * hil, hy * hil, hz * hil
    NoL = torch.clamp(n[0] * l[0] + n[1] * l[1] + n[2] * l[2], 0.0, 1.0)
    NoH = torch.clamp(n[0] * hx + n[1] * hy + n[2] * hz, 0.0, 1.0)
    VoH = torch.clamp(iv[0] * hx + iv[1] * hy + iv[2] * hz, 0.0, 1.0)
    denom_d = NoH * NoH * (a2 - 1.0) + 1.0
    D = a2 / (_PI * denom_d * denom_d)
    gl = NoL / (NoL * (1.0 - k) + k)
    G = gl * gv
    x = 1.0 - VoH
    x2 = x * x
    fr = x2 * x2 * x
    spec = D * G / (4.0 * NoL * NoV + 1e-4)
    return [(cd[c] * _INV_PI + spec * (f0[c] + (1.0 - f0[c]) * fr)) * NoL
            for c in range(3)]


def _walk_setup(inp: dict, width: int, height: int):
    """Per pixel of the row-major G-buffer: (tile index, x, y, valid,
    the z range [near_d, far_d] of its Doom slice, its tile's count)."""
    chan = inp["chan"]
    dev = chan.device
    fx, _ = tile_grid(width, height)
    ys = torch.arange(height, device=dev).repeat_interleave(width)
    xs = torch.arange(width, device=dev).repeat(height)
    tile = (ys // TILE_PX) * fx + xs // TILE_PX
    scal = inp["scal"]
    near, lr = scal[0], scal[2]
    si = cluster_index_z(chan[11], near, scal[1]).to(torch.float32)
    near_d = torch.where(si == 0.0, 0.0, near * torch.exp(si * _INV_Z * lr))
    far_d = near * torch.exp((si + 1.0) * _INV_Z * lr)
    return tile, xs, ys, chan[12] > 0.0, near_d, far_d, inp["counts"][tile]


def _list_entry(inp: dict, tile, j: int, near_d, far_d, count_px):
    """List entry j of each pixel's tile -> (its light rows, radius, the
    z-slab test against the pixel's slice, false past the count)."""
    li = inp["lists"][:, j].long()[tile]
    row = inp["rows"][1 + li]
    zl = inp["lvz"][li]
    rl = row[:, 7]
    vis = (((-zl - near_d) >= -rl) & ((zl + far_d) >= -rl)
           & (j < count_px))
    return row, rl, vis


def shade_clustered_tiles_plain(inp: dict, width: int, height: int,
                                return_counts: bool = False):
    """Plain PyTorch version of the kernel -> (R, 3). With return_counts
    -> (color, count, needed), per pixel: count, the number of visible
    listed point lights (the kernel's running count before the cap);
    needed, the number of list entries whose z-slab test can change the
    color (those up to the 128th visible light, else the whole list)."""
    chan, rows = inp["chan"], inp["rows"]
    tile, _, _, valid, near_d, far_d, count_px = _walk_setup(inp, width,
                                                             height)
    pos = [chan[0], chan[1], chan[2]]
    n = [chan[3], chan[4], chan[5]]
    alb = [chan[6], chan[7], chan[8]]
    rough, metal, z_cam = chan[9], chan[10], chan[11]
    scal = inp["scal"]

    iv = [scal[3] - pos[0], scal[4] - pos[1], scal[5] - pos[2]]
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(
        iv[0] * iv[0] + iv[1] * iv[1] + iv[2] * iv[2], 1e-40))
    iv = [c * inv_len for c in iv]
    NoV = torch.clamp(n[0] * iv[0] + n[1] * iv[1] + n[2] * iv[2], 0.0, 1.0)
    f0 = [0.04 * (1.0 - metal) + a * metal for a in alb]
    cd = [a * 0.96 * (1.0 - metal) for a in alb]
    alpha = rough * rough
    k = torch.clamp_min(alpha * 0.5, 1e-4)
    a2 = alpha * alpha
    gv = NoV / (NoV * (1.0 - k) + k)
    shade = (iv, n, NoV, f0, cd, a2, k, gv)

    acc = [torch.zeros_like(z_cam) for _ in range(3)]
    cnt = torch.zeros_like(z_cam)
    needed = count_px.clone()
    for j in range(int(inp["counts"].max())):
        row, rl, vis = _list_entry(inp, tile, j, near_d, far_d, count_px)
        shaded = vis & (cnt < MAX_FROXEL_LIGHTS)
        t = [row[:, 4] - pos[0], row[:, 5] - pos[1], row[:, 6] - pos[2]]
        d2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        inv_d = 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-20))
        l = [c * inv_d for c in t]
        dpr = torch.clamp_min(d2, 1e-20) * inv_d / torch.clamp_min(rl, 1e-20)
        dpr2 = dpr * dpr
        radial = torch.clamp(1.0 - dpr2 * dpr2, 0.0, 1.0)
        w = torch.where(shaded, radial / torch.clamp_min(d2, 1e-20), 0.0)
        b = _light_contrib(l, *shade)
        acc = [acc[c] + row[:, 1 + c] * w * b[c] for c in range(3)]
        if return_counts:
            last = vis & (cnt == MAX_FROXEL_LIGHTS - 1)
            needed = torch.where(last, j + 1, needed)
        cnt = cnt + vis.to(torch.float32)

    pc = inp["ints"][0].long()
    for j in range(int(inp["ints"][1])):
        row = rows.index_select(0, (1 + pc + j).reshape(1))[0]
        t = [row[4] - pos[0], row[5] - pos[1], row[6] - pos[2]]
        d2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        inv_d = 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-20))
        l = [c * inv_d for c in t]
        cdot = -(row[8] * l[0] + row[9] * l[1] + row[10] * l[2])
        ang = torch.clamp(cdot * row[7] + row[11], 0.0, 1.0)
        fall = ang * ang / torch.clamp_min(d2, 1e-20)
        b = _light_contrib(l, *shade)
        acc = [acc[c] + row[1 + c] * fall * b[c] for c in range(3)]

    out = torch.where(valid[:, None], torch.stack(acc, dim=1), 0.0)
    if return_counts:
        return out, cnt, needed
    return out


def shade_walk_counts_plain(inp: dict, width: int, height: int):
    """Plain version of the measurement form -> (R, 3) f32 per pixel: the
    point lights it shades (min(count, 128), 0 without a surface); the
    list entries its warp walks before the warp exit (the most `needed`
    of a lane with a surface, 0 without one); its warp's shading union,
    the entries at which some lane with a surface shades. A warp is the
    32 pixels of one tile row, some outside the image in a ragged tile."""
    tile, xs, ys, valid, near_d, far_d, count_px = _walk_setup(
        inp, width, height)
    fx, _ = tile_grid(width, height)
    warp = ys * fx + xs // TILE_PX
    n_warps = height * fx
    cnt = torch.zeros_like(near_d)
    needed = count_px.clone()
    union = torch.zeros(n_warps, dtype=torch.float32, device=near_d.device)
    for j in range(int(inp["counts"].max())):
        _, _, vis = _list_entry(inp, tile, j, near_d, far_d, count_px)
        shaded = vis & valid & (cnt < MAX_FROXEL_LIGHTS)
        union += torch.zeros_like(union).scatter_reduce_(
            0, warp, shaded.to(torch.float32), "amax")
        needed = torch.where(vis & (cnt == MAX_FROXEL_LIGHTS - 1), j + 1,
                             needed)
        cnt = cnt + vis.to(torch.float32)
    walked = torch.zeros_like(union).scatter_reduce_(
        0, warp, torch.where(valid, needed, 0).to(torch.float32), "amax")
    shaded = torch.where(valid, torch.clamp_max(cnt, MAX_FROXEL_LIGHTS), 0.0)
    return torch.stack([shaded, walked[warp], union[warp]], dim=1)


# the C entry points' arguments before the stream (cuda_build.launch)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _launch(symbol: str, inp: dict, width: int, height: int):
    """Check K5's inputs and launch the entry point `symbol` -> (R, 3)."""
    chan = inp["chan"]
    dev = chan.device
    R = width * height
    if dev.type != "cuda":
        raise ValueError(f"{symbol}: unsupported device {dev}")
    from . import cuda_build
    from .trace_bvh import expect_tensor

    fx, fy = tile_grid(width, height)
    expect_tensor(chan, "chan", torch.float32, dev, (CHANNELS, R))
    expect_tensor(inp["rows"], "rows", torch.float32, dev, (None, 12))
    lcap = inp["lists"].shape[1]
    expect_tensor(inp["lists"], "lists", torch.int32, dev, (fx * fy, lcap))
    expect_tensor(inp["counts"], "counts", torch.int32, dev, (fx * fy,))
    expect_tensor(inp["lvz"], "lvz", torch.float32, dev, (lcap,))
    expect_tensor(inp["ints"], "ints", torch.int32, dev, (2,))
    expect_tensor(inp["scal"], "scal", torch.float32, dev, (8,))
    if inp["rows"].shape[0] < 1 + lcap:
        raise ValueError("rows must hold the sun and every listed light")
    out = torch.empty((R, 3), dtype=torch.float32, device=dev)
    cuda_build.launch("shade_tiles", symbol, _ARGTYPES, dev, (
        chan.data_ptr(), width, height, inp["rows"].data_ptr(),
        inp["lvz"].data_ptr(), inp["lists"].data_ptr(), lcap,
        inp["counts"].data_ptr(), inp["ints"].data_ptr(),
        inp["scal"].data_ptr(), out.data_ptr()))
    return out


def shade_clustered_tiles(inp: dict, width: int, height: int):
    """Clustered point + spot shading of a width x height G-buffer ->
    (R, 3) linear color, R = width * height; `inp` from tile_inputs."""
    if inp["chan"].device.type == "cpu":
        return shade_clustered_tiles_plain(inp, width, height)
    out = _launch("shade_clustered_tiles", inp, width, height)
    shade_clustered_tiles.launches += 1
    return out


def shade_walk_counts(inp: dict, width: int, height: int):
    """K5's measurement form on the inputs of shade_clustered_tiles ->
    (R, 3) f32, as shade_walk_counts_plain: the walk without the
    shading."""
    if inp["chan"].device.type == "cpu":
        return shade_walk_counts_plain(inp, width, height)
    out = _launch("shade_walk_counts", inp, width, height)
    shade_walk_counts.launches += 1
    return out


shade_clustered_tiles.launches = 0
shade_walk_counts.launches = 0
KERNELS = (shade_clustered_tiles, shade_walk_counts)
