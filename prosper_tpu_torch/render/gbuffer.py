"""G-buffer from primary visibility, with optional two-phase culling.

Counterpart of prosper_tpu/render/gbuffer.py `render_gbuffer` (:120) in
row order, with the encodings of gbuffer.frag: albedo + roughness, the
signed-octahedron normal + metallic, the NDC velocity without the jitter
(y negated, clamped), reverse-z depth, and the view-space z that the
froxel lookup reads.

Primary rays are the primary kernel's (K1): pixel centres shifted by the
TAA jitter through the affine camera uniforms of
ops/trace_bvh.gbuffer_rays. Without culling K1 traces every pixel.
With culling (the reference's GPU-driven two-phase meshlet pipeline) the
same rays, from ops/trace_bvh.gbuffer_rays, go through K4 twice: phase 1
against the clusters that survive frustum, cone and previous-HiZ
culling; then a fresh HiZ from phase-1 depth; phase 2 against the
depth-culled clusters that the fresh HiZ no longer hides; the hits merge
by min t. Both paths trace the same rays, so the culled G-buffer equals
the unculled one wherever culling is conservative.

A frame without BVH arrays traces the same rays with the flat kernel K8
(ops/trace_flat.py) in 16x16 pixel blocks: over the cluster AABBs, and
over masked (inverted) AABBs in the culling phases. With alpha_rounds >
0 the alpha-mask discard (`mask_discard_retrace`) re-traces the hits
whose mask test fails, with K4 or K8 over every cluster.

y_offset and full_height render a horizontal band of a taller frame
(render/distributed.py): `height` rows from absolute row y_offset of a
full_height frame, through K1's camera uniforms with the band offset
(ops/trace_bvh.primary_cam_vec) on band-local pixel rows, so the uv rows
are (py + y_offset + 0.5) / full_height. The ray-cone spread is the full
frame's, pixel_cone_alpha(cam, full_height): the band's rows equal the
full frame's. (The JAX package takes the band's own height there,
gbuffer.py:372, so its bands sample coarser mips than its single-device
frame on textured scenes.) Culling is not supported per band.

The outputs are in row-major order: the TPU package's block16 output
order, its tile compaction (`tile_apply`) and primary tile mask serve
its packets and are not carried.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch

from ..mathx.packing import pack_velocity, signed_oct_encode
from ..ops.culling import (
    cull_clusters,
    sphere_occluded,
    transform_cluster_bounds,
)
from ..ops.hiz import build_hiz
from ..ops.intersect import BIG
from ..ops.slabs import unpack_hit16
from ..ops.texture import sample_alpha_packed
from ..ops.trace import frame_bvh, traced_in_blocks
from ..ops.trace_bvh import (
    check_stack_overflow,
    gbuffer_rays,
    pack_pixels_np,
    trace_closest_bvh_full,
    trace_primary_bvh_full,
)
from ..ops.trace_flat import trace_closest_flat_full
from ..utils.profiler import gprofiler
from .surface import evaluate_surface_from_attrs, pixel_cone_alpha

GBUFFER_T_MIN = 1e-4  # the t_min render/gbuffer.py passes (:252, :273)


def _masked_aabbs(wc_min, wc_max, mask):
    """Inverted (empty) AABBs for the clusters `mask` marks False: the
    flat kernels' packet cull never lists them (the draw list's
    analog)."""
    return (torch.where(mask[:, None], wc_min, BIG),
            torch.where(mask[:, None], wc_max, -BIG))


def _material_uv(static: dict, rows: torch.Tensor):
    """Material id and uv of each hit row: read from (R, 16) full rows,
    interpolated from a_packed for (R, 8) rows t | tri | u | v."""
    if rows.shape[1] == 16:
        return rows[:, 11].long(), rows[:, 9:11]
    tri = torch.clamp_min(rows[:, 1], 0).long()
    aidx = static["wt_aidx"][tri].long()
    ap = static["a_packed"]
    u, v = rows[:, 2:3], rows[:, 3:4]
    uv = ((1.0 - u - v) * ap[aidx[:, 0], 7:9] + u * ap[aidx[:, 1], 7:9]
          + v * ap[aidx[:, 2], 7:9])
    return static["wt_material"][tri], uv


def mask_discard_retrace(arena: dict, static: dict, trace_fn, o, d, rows,
                         rounds: int):
    """Alpha-mask discard of the raster paths (gbuffer.frag:61-63,
    forward.frag:56-58): a hit on an alpha-masked material whose alpha
    fails its cutoff is ignored, and its ray re-traced from just past
    it, up to `rounds` layers (render/gbuffer.py:25-107).

    rows: (R, 8) or (R, 16) hit rows of the rays (o, d), the form
    trace_fn(o, d, t_min, t_max) returns. Dense: every round re-traces
    all rays, with t_max = 0 (no hit) for those not ignored; the JAX
    package's tile compaction is a TPU device. Returns the rows with t
    measured from the original origins."""
    t_off = torch.zeros_like(rows[:, 0])
    for _ in range(rounds):
        mat, uv = _material_uv(static, rows)
        ignore = (rows[:, 1] >= 0) & (sample_alpha_packed(arena, mat, uv)
                                      == 0.0)
        adv = torch.where(ignore, rows[:, 0] * (1.0 + 1e-4) + 1e-5, 0.0)
        o = o + d * adv[:, None]
        t_off = t_off + adv
        again = trace_fn(o, d, 0.0, torch.where(ignore, float("inf"), 0.0))
        rows = torch.where(ignore[:, None], again, rows)
    return torch.cat([(rows[:, 0] + t_off)[:, None], rows[:, 1:]], dim=1)


def full_tracer(scene: dict, width: int, height: int):
    """mask -> fn(o, d, t_min, t_max) -> (R, 16) full rows for the
    row-major rays of a whole frame, over the clusters `mask` (C,) bool
    keeps (None: all): K4 with the mask as its skip mask on a frame with
    BVH arrays, else K8 over the masked AABBs in 16x16 pixel blocks."""
    slabs, frame = scene["geom"]["packed_full"], scene["frame"]
    bvh = frame_bvh(frame)

    def tracer(mask=None):
        if bvh is not None:
            return partial(trace_closest_bvh_full, slabs, *bvh,
                           skip_mask=mask)
        mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
        if mask is not None:
            mn, mx = _masked_aabbs(mn, mx, mask)
        return traced_in_blocks(partial(trace_closest_flat_full, slabs, mn,
                                        mx), width, height)

    return tracer


@lru_cache(maxsize=4)
def _row_pixels(width: int, height: int, device: str) -> torch.Tensor:
    """The primary kernel's (T, 3, 256) layout of the row-major pixels."""
    px = np.tile(np.arange(width), height)
    py = np.repeat(np.arange(height), width)
    return torch.as_tensor(pack_pixels_np(px, py)[0], device=device)


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=-1)


def _project(m, p):
    """NDC xyz of world points p under the (4, 4) matrix m."""
    clip = _homogeneous(p) @ m.T
    w = clip[:, 3:4]
    return clip[:, :3] / torch.clamp_min(w.abs(), 1e-20) * torch.sign(w)


def _cull_and_trace(scene, cam, o, d, width, height, prev_hiz, tracer):
    """Two-phase culled trace -> ((R, 16) full rows, fresh HiZ, stats)."""
    static, frame = scene["static"], scene["frame"]

    def trace(mask):
        return tracer(mask)(o, d, GBUFFER_T_MIN, float("inf"))

    uniform_scales = torch.sqrt(
        (frame["transforms"][:, :, :3] ** 2).sum(dim=1)).amax(dim=-1)
    cull1 = cull_clusters(static, frame, cam, uniform_scales, prev_hiz or [],
                          width, height, output_second_phase=True)
    h16 = trace(cull1["visible"])

    # fresh HiZ from phase-1 depth
    w2clip = cam["camera_to_clip"] @ cam["world_to_camera"]
    t1 = h16[:, 0]
    pos1 = o + torch.where(torch.isfinite(t1), t1, 0.0)[:, None] * d
    clip = _homogeneous(pos1) @ w2clip.T
    depth1 = torch.where(h16[:, 1] >= 0, clip[:, 2] / clip[:, 3], 0.0)
    hiz = build_hiz(depth1.reshape(height, width), width, height)

    # phase 2: the depth-culled clusters the fresh HiZ no longer hides
    center, radius, _, _ = transform_cluster_bounds(static, frame,
                                                    uniform_scales)
    still = sphere_occluded(center, radius, cam, hiz, width, height)
    phase2 = cull1["second_phase"] & ~still
    h2 = trace(phase2)
    h16 = torch.where((h2[:, 0] < h16[:, 0])[:, None], h2, h16)
    stats = {
        "drawn_meshlets": cull1["drawn_meshlets"] + phase2.sum(),
        "rasterized_triangles": cull1["rasterized_triangles"],
    }
    return h16, hiz, stats


def render_gbuffer(scene: dict, cam: dict, width: int, height: int,
                   use_culling: bool = False, prev_hiz: list | None = None,
                   alpha_rounds: int = 0, aniso_taps: int = 1,
                   lod_bias: float = 0.0, y_offset: int = 0,
                   full_height: int | None = None) -> dict:
    """Trace the primary rays and produce the G-buffer dict (flat R = W*H,
    row-major): albedo_roughness (R, 4), normal_metallic (R, 4), velocity
    (R, 2), depth, z_cam (-inf without a surface), position_ws, valid,
    the shading `surface`, the fresh `hiz` (culling only, else None) and
    `draw_stats`. y_offset, full_height: the band of a taller frame (see
    the module docstring). Raises if a trace kernel overflowed its node
    stack, and for culling on a band."""
    full_h = height if full_height is None else full_height
    if use_culling and (y_offset or full_h != height):
        raise ValueError("culling is not supported per band")
    geom, frame = scene["geom"], scene["frame"]
    dev = geom["packed_full"].device
    R = width * height
    cols = _row_pixels(width, height, str(dev))
    cam_vec, o, d, _ = gbuffer_rays(cam, width, full_h, cols, device=dev,
                                    y_offset=y_offset)
    o, d = o[:R].contiguous(), d[:R]

    tracer = full_tracer(scene, width, height)
    hiz, stats = None, {}
    if use_culling:
        h16, hiz, stats = _cull_and_trace(scene, cam, o, d, width, height,
                                          prev_hiz, tracer)
    elif frame_bvh(frame) is not None:
        h16 = trace_primary_bvh_full(
            geom["packed_full"], frame["bvh_bounds"], frame["bvh_meta"],
            cols, cam_vec, 0, GBUFFER_T_MIN,
        )[:R]
    else:
        h16 = tracer()(o, d, GBUFFER_T_MIN, float("inf"))
    if alpha_rounds:
        h16 = mask_discard_retrace(scene["arena"], scene["static"], tracer(),
                                   o, d, h16, alpha_rounds)
    check_stack_overflow(dev, "gbuffer.stack_check")

    hit = unpack_hit16(h16)
    # ray-cone mip selection (lodBias -1 under TAA, else 0;
    # Renderer.cpp:709-715)
    cone = {"alpha": pixel_cone_alpha(cam, full_h), "bias": lod_bias,
            "aniso_taps": aniso_taps}
    surface = evaluate_surface_from_attrs(scene["arena"], o, d, hit,
                                          cone=cone,
                                          tris_packed=geom["packed_full"])
    valid = hit["tri"] >= 0
    # safe normal without a surface (the oct encoding of 0 is NaN)
    up = surface["normal_ws"].new_zeros(3)
    with gprofiler.wait("gbuffer.safe_normal"):  # the 1.0 goes up
        up[2] = 1.0
    surface["normal_ws"] = torch.where(valid[:, None], surface["normal_ws"],
                                       up)
    pos_safe = torch.where(valid[:, None], surface["position_ws"], 0.0)

    # current and previous clip positions for velocity (gbuffer.frag:74-84)
    ndc = _project(cam["world_to_clip"], pos_safe)
    prev_ndc = _project(cam["prev_world_to_clip"], pos_safe)
    velocity = (ndc[:, :2] - cam["current_jitter"]) - (
        prev_ndc[:, :2] - cam["previous_jitter"])
    velocity = torch.stack([velocity[:, 0], -velocity[:, 1]], dim=-1)
    w2c = cam["world_to_camera"]
    z_cam = pos_safe @ w2c[2, :3] + w2c[2, 3]
    return {
        "albedo_roughness": torch.cat(
            [surface["albedo"], surface["roughness"][:, None]], dim=-1),
        "normal_metallic": torch.cat(
            [signed_oct_encode(surface["normal_ws"]),
             surface["metallic"][:, None]], dim=-1),
        "velocity": torch.where(valid[:, None], pack_velocity(velocity), 0.0),
        "depth": torch.where(valid, ndc[:, 2], 0.0),  # reverse-z: far = 0
        "z_cam": torch.where(valid, z_cam, float("-inf")),
        "position_ws": pos_safe,
        "valid": valid,
        "surface": surface,
        "hiz": hiz,
        "draw_stats": stats,
    }
