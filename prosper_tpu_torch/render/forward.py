"""Forward mode: primary visibility by ray casting, then forward shading.

Counterpart of prosper_tpu/render/forward.py `eval_all_lights` (:30) and
`render_forward` (:82-211), forward.frag of the reference: pixel-centre
primary rays (no jitter) traced in 16x16 pixel blocks, the alpha-mask
discard, the surface from the hit's gathered vertex attributes
(render/surface.evaluate_surface, with the pixel's ray cone), the sun
plus the clustered point and spot lights of the tile kernel (K5), the
transparent pass, the tone map; or, with a draw type, a debug AOV.

The trace: K2 over the BVH; under the transparent pass the opaque pass
leaves the blend clusters out through masked (inverted) AABBs, which
only the flat kernel K6 reads, as ops/trace.make_tracer decides; a frame
without BVH arrays takes K6 too. The JAX package's tile compaction and
its XLA froxel path are TPU and CPU devices and are not carried.
"""

from __future__ import annotations

import torch

from ..ops.brdf import eval_brdf_times_nol
from ..ops.rays import pinhole_rays
from ..ops.slabs import unpack_hit8
from ..ops.tonemap import device_lut, tone_map
from ..ops.trace import block_order, frame_bvh, make_tracer
from ..ops.trace_bvh import check_stack_overflow
from ..scene.convert import camera_tensors, check_device
from ..utils.profiler import gprofiler
from .debug import DrawType, debug_color
from .gbuffer import _masked_aabbs, mask_discard_retrace
from .shading import (
    eval_directional_light,
    point_light_irradiance,
    shade_direct,
    spot_light_irradiance,
)
from .surface import evaluate_surface, pixel_cone_alpha
from .transparent import blend_cluster_mask, transparent_pass

FORWARD_T_MIN = 1e-4  # render/forward.py:134


def eval_all_lights(surface: dict, lights: dict) -> torch.Tensor:
    """The sun and every point and spot light, unshadowed: the
    O(pixels x lights) reference of forward.frag's light loop. The frame
    shades with the clustered tile kernel, which equals it because a
    light's falloff is zero beyond its radius and the froxel lists are
    conservative."""
    color = eval_directional_light(surface, lights)
    pos = surface["position_ws"]
    terms = (surface["inv_view_ray"], surface["normal_ws"], surface["albedo"],
             surface["roughness"], surface["metallic"])
    n_point = min(int(lights["point_count"]), lights["point_position"].shape[0])
    for i in range(n_point):
        l, _, irr = point_light_irradiance(lights, i, pos)
        color = color + irr * eval_brdf_times_nol(l, *terms)
    n_spot = min(int(lights["spot_count"]), lights["spot_position"].shape[0])
    for i in range(n_spot):
        l, _, irr = spot_light_irradiance(lights, i, pos)
        color = color + irr * eval_brdf_times_nol(l, *terms)
    return color


def pixel_center_rays(cam: dict, width: int, height: int, device):
    """The forward pass's primary rays through the pixel centres (no
    jitter), in 16x16-block order (ops/trace.block_order) -> (o, d), (R,
    3) each."""
    order, _ = block_order(width, height, str(device))
    uv = torch.stack([((order % width).to(torch.float32) + 0.5) / width,
                      ((order // width).to(torch.float32) + 0.5) / height],
                     dim=-1)
    o, d = pinhole_rays(cam, uv)
    return o.contiguous(), d.contiguous()


def render_forward(scene: dict, cam: dict, lut, width: int, height: int,
                   exposure: float = 1.0, contrast: float = 1.0,
                   draw_type: int = 0, use_transparent: bool = False,
                   alpha_rounds: int = 0, aniso_taps: int = 1):
    """One forward frame -> (display image (H, W, 3), the number of
    pixels with an opaque surface). A draw type other than 0 returns
    its debug AOV, clipped to [0, 1] and not tone-mapped."""
    static, frame, arena = scene["static"], scene["frame"], scene["arena"]
    slabs = scene["geom"]["packed9"]
    dev = slabs.device
    o, d = pixel_center_rays(cam, width, height, dev)
    _, inverse = block_order(width, height, str(dev))
    wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    if use_transparent:
        # the opaque pass leaves the blend clusters to the transparent
        # pass (the draw list's alphaMode filter)
        mn, mx = _masked_aabbs(wc_min, wc_max, ~blend_cluster_mask(scene))
        closest, _ = make_tracer(slabs, mn, mx)
    else:
        closest, _ = make_tracer(slabs, wc_min, wc_max, bvh=frame_bvh(frame))
    rows = closest(o, d, FORWARD_T_MIN, float("inf"))
    if alpha_rounds:
        rows = mask_discard_retrace(arena, static, closest, o, d, rows,
                                    alpha_rounds)
    check_stack_overflow(dev, "forward.stack_check")
    hit = unpack_hit8(rows[inverse])
    o, d = o[inverse], d[inverse]
    cone = {"alpha": pixel_cone_alpha(cam, height), "bias": 0.0,
            "aniso_taps": aniso_taps}
    surface = evaluate_surface(static, frame, arena, o, d, hit, cone=cone)
    valid = surface["valid"]
    covered = valid.sum()
    if draw_type != 0:
        dbg = debug_color(DrawType(draw_type), surface, hit, static)
        dbg = torch.where(valid[:, None], dbg, 0.0)
        return torch.clamp(dbg.reshape(height, width, 3), 0.0, 1.0), covered
    # a miss has t = inf: its position stays out of the shading inputs
    surface["position_ws"] = torch.where(valid[:, None],
                                         surface["position_ws"], 0.0)
    w2c = cam["world_to_camera"]
    z_cam = torch.where(valid, surface["position_ws"] @ w2c[2, :3] + w2c[2, 3],
                        float("-inf"))
    hdr = shade_direct(surface, frame["lights"], cam, z_cam, valid, width,
                       height).reshape(height, width, 3)
    if use_transparent:
        hdr = transparent_pass(scene, cam, hdr, z_cam, width, height)
    return tone_map(hdr, lut, exposure, contrast), covered


def forward_entry(*, scene, cam, lut, width, height, device="cuda",
                  exposure=1.0, contrast=1.0, state=None, draw_type=0,
                  use_transparent=False, alpha_rounds=0, aniso_taps=1,
                  frame_index=0):
    """Forward mode: one frame -> (image (H, W, 3), state) on `device`
    (the card unless the caller asks for the CPU). The forward frame
    keeps nothing from frame to frame: state passes through with the
    frame's "covered_pixels" count. frame_index is accepted for the mode
    table's uniform call; the frame does not read it."""
    with gprofiler.frame("forward", frame_index):
        dev = check_device(scene, device)
        state = dict(state) if state else {}
        img, state["covered_pixels"] = render_forward(
            scene, camera_tensors(cam, dev), device_lut(lut, dev), width,
            height, exposure, contrast, draw_type=draw_type,
            use_transparent=use_transparent, alpha_rounds=alpha_rounds,
            aniso_taps=aniso_taps,
        )
    return img, state
