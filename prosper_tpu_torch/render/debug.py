"""Debug draw types: per-pixel AOVs instead of the shaded image.

Counterpart of prosper_tpu/render/debug.py `DrawType` and `debug_color`
(:27-86): the DrawType enum of the reference (DrawType.hpp:8-12) and
commonDebugDraw's mapping (debug.glsl:17-38), ids as the pcg pastel hash
colors of mathx/rng.uint_to_color. The JAX package's texture dump and
debug lines are not ported.
"""

from __future__ import annotations

from enum import IntEnum

import torch

from ..mathx.rng import uint_to_color


class DrawType(IntEnum):
    DEFAULT = 0
    PRIMITIVE_ID = 1
    MESHLET_ID = 2
    MESH_ID = 3
    MATERIAL_ID = 4
    POSITION = 5
    SHADING_NORMAL = 6
    TEXCOORD0 = 7
    ALBEDO = 8
    ROUGHNESS = 9
    METALLIC = 10


def debug_color(draw_type: DrawType, surface: dict, hit: dict,
                static: dict) -> torch.Tensor:
    """(R, 3) debug AOV of each pixel's surface; magenta for an unknown
    type."""
    tri = torch.clamp_min(hit["tri"], 0).long()
    meshlet = tri // 128
    shape = surface["albedo"].shape
    if draw_type == DrawType.PRIMITIVE_ID:
        return uint_to_color(tri)
    if draw_type == DrawType.MESHLET_ID:
        return uint_to_color(meshlet)
    if draw_type == DrawType.MESH_ID:
        return uint_to_color(static["wc_instance"][meshlet])
    if draw_type == DrawType.MATERIAL_ID:
        return uint_to_color(surface["material"])
    if draw_type == DrawType.POSITION:
        return surface["position_ws"]
    if draw_type == DrawType.SHADING_NORMAL:
        return surface["normal_ws"] * 0.5 + 0.5
    if draw_type == DrawType.TEXCOORD0:
        return torch.cat([surface["uv"], torch.zeros_like(surface["uv"][:, :1])],
                         dim=-1)
    if draw_type == DrawType.ALBEDO:
        return surface["albedo"]
    if draw_type == DrawType.ROUGHNESS:
        return surface["roughness"][:, None].expand(shape)
    if draw_type == DrawType.METALLIC:
        return surface["metallic"][:, None].expand(shape)
    magenta = surface["albedo"].new_zeros(3)
    magenta[0] = magenta[2] = 1.0
    return magenta.expand(shape)
