"""Light data with the reference's conventions, in numpy.

A copy of prosper_tpu/scene/lights.py `MAX_POINT_LIGHTS`,
`MAX_SPOT_LIGHTS`, `LightArrays` and `light_uniforms` (:23-132): 1
directional + <= 1024 point + <= 1024 spot lights
(Light.hpp:27,45 of the reference), the directional default (2,2,2)
along (-1,-1,-1) (lights.h:17-20), and the packed (1 + P + S, 12) rows in
sampleLight order. The port keeps its own copy so that it imports
nothing of the JAX package; `load_lights` needs the glTF path (ROADMAP.md
queue 1, "Scene path without JAX").
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
