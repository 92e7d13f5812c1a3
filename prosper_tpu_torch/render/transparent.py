"""The transparent pass: the nearest blend surface over the opaque frame.

Counterpart of prosper_tpu/render/transparent.py `blend_cluster_mask`
(:27) and `transparent_pass` (:33-153), ForwardRenderer::
recordTransparent of the reference: the frame's primary rays traced
against the blend-material clusters alone (the draw list's alphaMode
filter), the nearest such surface shaded as the opaque path shades
(the sun and the clustered lights of K5) and alpha-blended over the
opaque image where it lies in front of the opaque surface: one unsorted
layer.

The trace: K4 with the blend clusters as its skip mask on a frame with
BVH arrays, K8 over the masked AABBs without (render/gbuffer.
full_tracer). The rays are the G-buffer's (ops/trace_bvh.gbuffer_rays),
so a blend surface that the deferred G-buffer drew as opaque lies at
exactly the G-buffer's depth and is not blended again, as in the JAX
package. With ibl_data the blend surface also takes the IBL term
(ops/ibl.eval_ibl, transparent.py:143-146). The JAX package's tile
compaction (`tile_apply`) is a TPU device and is not carried.
"""

from __future__ import annotations

import torch

from ..ops.ibl import eval_ibl
from ..ops.slabs import unpack_hit16
from ..ops.trace_bvh import gbuffer_rays
from .gbuffer import _row_pixels, full_tracer
from .shading import shade_direct
from .surface import evaluate_surface_from_attrs, pixel_cone_alpha

TRANSPARENT_T_MIN = 1e-4  # render/transparent.py:82, :86, :117


def blend_cluster_mask(scene: dict) -> torch.Tensor:
    """(C,) bool: the clusters whose material's alphaMode is 2 (Blend)."""
    mat_i32 = scene["arena"]["mat_i32"]
    return mat_i32[scene["static"]["wc_material"].long(), 0] == 2


def transparent_pass(scene: dict, cam: dict, hdr: torch.Tensor,
                     opaque_z_cam: torch.Tensor, width: int, height: int,
                     ibl_data: dict | None = None) -> torch.Tensor:
    """Alpha-blend the nearest blend-material surface over hdr (H, W, 3)
    where its view-space z is nearer than opaque_z_cam (R,), row-major
    (-inf without an opaque surface). Returns the blended (H, W, 3)."""
    dev = hdr.device
    R = width * height
    cols = _row_pixels(width, height, str(dev))
    _, o, d, _ = gbuffer_rays(cam, width, height, cols, device=dev)
    o, d = o[:R].contiguous(), d[:R]
    trace = full_tracer(scene, width, height)(blend_cluster_mask(scene))
    hit = unpack_hit16(trace(o, d, TRANSPARENT_T_MIN, float("inf")))
    cone = {"alpha": pixel_cone_alpha(cam, height), "bias": 0.0}
    surface = evaluate_surface_from_attrs(scene["arena"], o, d, hit,
                                          cone=cone)
    w2c = cam["world_to_camera"]
    z_cam = surface["position_ws"] @ w2c[2, :3] + w2c[2, 3]
    valid = (hit["tri"] >= 0) & (z_cam > opaque_z_cam)  # nearer (view -z)
    # a miss has t = inf: its position stays out of the shading inputs
    surface["position_ws"] = torch.where(valid[:, None],
                                         surface["position_ws"], 0.0)
    z_cam = torch.where(valid, z_cam, float("-inf"))
    color = shade_direct(surface, scene["frame"]["lights"], cam, z_cam, valid,
                         width, height)
    if ibl_data is not None:
        # a miss's surface is not finite: masked before the blend
        color = torch.where(valid[:, None],
                            color + eval_ibl(surface, ibl_data), 0.0)
    color = color.reshape(height, width, 3)
    a = torch.clamp(surface["alpha"], 0.0, 1.0)
    blend = torch.where(valid, a, 0.0).reshape(height, width, 1)
    return hdr * (1.0 - blend) + color * blend
