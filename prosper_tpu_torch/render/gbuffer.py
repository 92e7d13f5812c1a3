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

The pixels are in row-major order throughout: the TPU package's
block16 order, its tile compaction (`tile_apply`), primary tile mask and
band y_offset serve its packets and are not carried.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..mathx.packing import pack_velocity, signed_oct_encode
from ..ops.culling import (
    cull_clusters,
    sphere_occluded,
    transform_cluster_bounds,
)
from ..ops.hiz import build_hiz
from ..ops.slabs import unpack_hit16
from ..ops.trace_bvh import (
    check_stack_overflow,
    gbuffer_rays,
    pack_pixels_np,
    trace_closest_bvh_full,
    trace_primary_bvh_full,
)
from .surface import evaluate_surface_from_attrs, pixel_cone_alpha

GBUFFER_T_MIN = 1e-4  # the t_min render/gbuffer.py passes (:252, :273)


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


def _cull_and_trace(scene, cam, o, d, width, height, prev_hiz):
    """Two-phase culled trace -> ((R, 16) full rows, fresh HiZ, stats)."""
    static, frame, geom = scene["static"], scene["frame"], scene["geom"]
    bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]

    def trace(mask):
        return trace_closest_bvh_full(geom["packed_full"], bounds, meta, o, d,
                                      GBUFFER_T_MIN, float("inf"),
                                      skip_mask=mask)

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
                   alpha_rounds: int = 0, aniso_taps: int = 1) -> dict:
    """Trace the primary rays and produce the G-buffer dict (flat R = W*H,
    row-major): albedo_roughness (R, 4), normal_metallic (R, 4), velocity
    (R, 2), depth, z_cam (-inf without a surface), position_ws, valid,
    the shading `surface`, the fresh `hiz` (culling only, else None) and
    `draw_stats`. Raises if a trace kernel overflowed its node stack."""
    if alpha_rounds:
        raise NotImplementedError(
            "alpha_rounds > 0 needs the alpha-mask discard retrace "
            "(render/gbuffer.py mask_discard_retrace): ROADMAP.md queue 1, "
            "item 'Deferred'"
        )
    geom, frame = scene["geom"], scene["frame"]
    dev = geom["packed_full"].device
    R = width * height
    cols = _row_pixels(width, height, str(dev))
    cam_vec, o, d, _ = gbuffer_rays(cam, width, height, cols, device=dev)
    o, d = o[:R].contiguous(), d[:R]

    hiz, stats = None, {}
    if use_culling:
        h16, hiz, stats = _cull_and_trace(scene, cam, o, d, width, height,
                                          prev_hiz)
    else:
        h16 = trace_primary_bvh_full(
            geom["packed_full"], frame["bvh_bounds"], frame["bvh_meta"],
            cols, cam_vec, 0, GBUFFER_T_MIN,
        )[:R]
    check_stack_overflow(dev)

    hit = unpack_hit16(h16)
    # ray-cone mip selection (lodBias is 0 without TAA, which the port
    # does not have; Renderer.cpp:709-715)
    cone = {"alpha": pixel_cone_alpha(cam, height), "bias": 0.0,
            "aniso_taps": aniso_taps}
    surface = evaluate_surface_from_attrs(scene["arena"], o, d, hit,
                                          cone=cone)
    valid = hit["tri"] >= 0
    # safe normal without a surface (the oct encoding of 0 is NaN);
    # filled on the device: a tensor from a list would wait for it
    up = surface["normal_ws"].new_zeros(3)
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
