"""Light data with the reference's conventions, in numpy.

A copy of prosper_tpu/scene/lights.py (:23-132): 1 directional + <= 1024
point + <= 1024 spot lights (Light.hpp:27,45 of the reference), the
directional default (2,2,2) along (-1,-1,-1) (lights.h:17-20),
`load_lights` with the reference's glTF unit conversions
(WorldData.cpp:1456-1530: irradiance = color * intensity; point and spot
radiance = color * intensity / 4pi; a point radius of range, else
sqrt(luminance / 0.01); the glTF angular attenuation scale and offset),
and the packed (1 + P + S, 12) rows in sampleLight order. The port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_POINT_LIGHTS = 1024
MAX_SPOT_LIGHTS = 1024


@dataclass
class LightArrays:
    """Fixed-capacity SoA light buffers (the lightData ring analog)."""

    dir_irradiance: np.ndarray = field(
        default_factory=lambda: np.array([2.0, 2.0, 2.0], np.float32)
    )
    dir_direction: np.ndarray = field(
        default_factory=lambda: np.array([-1.0, -1.0, -1.0], np.float32)
    )
    # PointLight: radianceAndRadius, position (lights.h:22-26)
    point_radiance: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    )
    point_radius: np.ndarray = field(
        default_factory=lambda: np.ones(MAX_POINT_LIGHTS, np.float32)
    )
    point_position: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    )
    point_count: int = 0
    # SpotLight: radianceAndAngleScale, positionAndAngleOffset, direction
    spot_radiance: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    )
    spot_angle_scale: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SPOT_LIGHTS, np.float32)
    )
    spot_angle_offset: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_SPOT_LIGHTS, np.float32)
    )
    spot_position: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    )
    spot_direction: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    )
    spot_count: int = 0


def load_lights(doc) -> LightArrays:
    """Static light parameters of a scene.gltf.GltfDocument (positions
    and directions are filled per frame by scene_graph.update_scene)."""
    la = LightArrays()
    for light in doc.lights:
        color = light.color.astype(np.float32)
        if light.kind == "directional":
            la.dir_irradiance = color * np.float32(light.intensity)
        elif light.kind == "point":
            if la.point_count >= MAX_POINT_LIGHTS:
                continue
            radiance = color * np.float32(light.intensity) / (4.0 * np.pi)
            lum = float(np.dot(radiance, [0.2126, 0.7152, 0.0722]))
            radius = light.range if light.range > 0 else float(np.sqrt(lum / 0.01))
            la.point_radiance[la.point_count] = radiance
            la.point_radius[la.point_count] = radius
            la.point_count += 1
        elif light.kind == "spot":
            if la.spot_count >= MAX_SPOT_LIGHTS:
                continue
            angle_scale = 1.0 / max(
                0.001,
                float(np.cos(light.inner_cone_angle) - np.cos(light.outer_cone_angle)),
            )
            angle_offset = -float(np.cos(light.outer_cone_angle)) * angle_scale
            la.spot_radiance[la.spot_count] = color * np.float32(light.intensity) / (
                4.0 * np.pi
            )
            la.spot_angle_scale[la.spot_count] = angle_scale
            la.spot_angle_offset[la.spot_count] = angle_offset
            la.spot_count += 1
    return la


def light_uniforms(la: LightArrays) -> dict[str, np.ndarray]:
    """Device pytree for the shading kernels."""
    # Compact packed rows in sampleLight index order: sun, then the
    # *counted* points, then the counted spots (lighting.glsl:57-88).
    pc, sc = int(la.point_count), int(la.spot_count)
    rows = np.zeros((1 + MAX_POINT_LIGHTS + MAX_SPOT_LIGHTS, 12), np.float32)
    rows[0, 1:4] = la.dir_irradiance
    rows[0, 4:7] = la.dir_direction
    rows[1 : 1 + pc, 0] = 1.0
    rows[1 : 1 + pc, 1:4] = la.point_radiance[:pc]
    rows[1 : 1 + pc, 4:7] = la.point_position[:pc]
    rows[1 : 1 + pc, 7] = la.point_radius[:pc]
    rows[1 + pc : 1 + pc + sc, 0] = 2.0
    rows[1 + pc : 1 + pc + sc, 1:4] = la.spot_radiance[:sc]
    rows[1 + pc : 1 + pc + sc, 4:7] = la.spot_position[:sc]
    rows[1 + pc : 1 + pc + sc, 7] = la.spot_angle_scale[:sc]
    rows[1 + pc : 1 + pc + sc, 8:11] = la.spot_direction[:sc]
    rows[1 + pc : 1 + pc + sc, 11] = la.spot_angle_offset[:sc]
    return {
        "packed_rows": rows,
        "dir_irradiance": la.dir_irradiance,
        "dir_direction": la.dir_direction,
        "point_radiance": la.point_radiance,
        "point_radius": la.point_radius,
        "point_position": la.point_position,
        "point_count": np.int32(la.point_count),
        "spot_radiance": la.spot_radiance,
        "spot_angle_scale": la.spot_angle_scale,
        "spot_angle_offset": la.spot_angle_offset,
        "spot_position": la.spot_position,
        "spot_direction": la.spot_direction,
        "spot_count": np.int32(la.spot_count),
    }
