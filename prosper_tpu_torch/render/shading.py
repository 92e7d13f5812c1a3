"""Light evaluation and sampling over surface batches.

Counterpart of prosper_tpu/render/shading.py: `eval_directional_light`
(:21), which deferred shading calls; `sample_light` (:128) on
its packed-row path `sample_light_packed` (:90), the path PT takes, and
`point_light_irradiance` (:34) and `spot_light_irradiance` (:50), which
the JAX forward and clustered shading call on light dicts
(render/forward.py:43, ops/clustering.py:187) — lighting.glsl:14-88 of
the reference. Also `shade_direct`, the sun plus the clustered tile
kernel (K5), which the raster modes' opaque and transparent shading
share.
"""

from __future__ import annotations

import torch

from ..ops.brdf import eval_brdf_times_nol
from ..ops.shade_tiles import shade_clustered_tiles, tile_inputs


def _norm(v):
    return v / torch.clamp_min((v * v).sum(-1, keepdim=True).sqrt(), 1e-20)


def eval_directional_light(surface: dict, lights: dict):
    """Sun irradiance times the BRDF (evalDirectionalLight,
    lighting.glsl:8-12); unshadowed, as the raster modes shade it."""
    l = -_norm(lights["dir_direction"]).expand(surface["position_ws"].shape)
    return lights["dir_irradiance"] * eval_brdf_times_nol(
        l, surface["inv_view_ray"], surface["normal_ws"], surface["albedo"],
        surface["roughness"], surface["metallic"],
    )


def has_local_lights(lights: dict) -> bool:
    """Whether the frame's light arrays have point or spot slots, which
    the clustered tile kernel shades."""
    return bool(lights["point_position"].shape[0]
                or lights["spot_position"].shape[0])


def shade_direct(surface: dict, lights: dict, cam: dict, z_cam, valid,
                 width: int, height: int, light_lists=None, y_offset: int = 0,
                 full_height: int | None = None):
    """The sun and the clustered point and spot lights (K5, per 32x32
    froxel tile) at each pixel's surface -> (R, 3) linear color, zero
    where valid is False. light_lists: the tile lists, when the caller
    made them (ops/shade_tiles.build_tile_light_lists); y_offset,
    full_height: the band of a taller frame that the pixels are, with
    absolute froxel rows."""
    color = eval_directional_light(surface, lights)
    if has_local_lights(lights):
        color = color + shade_clustered_tiles(
            tile_inputs(surface, lights, cam, z_cam, valid, width, height,
                        light_lists, y_offset, full_height),
            width, height)
    return torch.where(valid[:, None], color, 0.0)


def point_light_irradiance(lights: dict, idx, pos_ws):
    """(l, d, irradiance) of point light idx at surface positions."""
    p = lights["point_position"][idx]
    radiance = lights["point_radiance"][idx]
    radius = lights["point_radius"][idx]
    to_light = p - pos_ws
    d2 = (to_light * to_light).sum(-1)
    d = torch.sqrt(d2)
    l = to_light / torch.clamp_min(d[..., None], 1e-20)
    dpr = d / radius
    dpr2 = dpr * dpr
    radial = torch.clamp(1.0 - dpr2 * dpr2, 0.0, 1.0)
    irr = radiance * (radial / torch.clamp_min(d2, 1e-20))[..., None]
    return l, d, irr


def spot_light_irradiance(lights: dict, idx, pos_ws):
    p = lights["spot_position"][idx]
    to_light = p - pos_ws
    d2 = (to_light * to_light).sum(-1)
    d = torch.sqrt(d2)
    l = to_light / torch.clamp_min(d[..., None], 1e-20)
    cd = (-lights["spot_direction"][idx] * l).sum(-1)
    ang = torch.clamp(
        cd * lights["spot_angle_scale"][idx] + lights["spot_angle_offset"][idx],
        0.0, 1.0,
    )
    ang = ang * ang
    irr = lights["spot_radiance"][idx] * (
        ang / torch.clamp_min(d2, 1e-20)
    )[..., None]
    return l, d, irr


def sample_light_packed(rows: torch.Tensor, light_index, pos_ws):
    """sampleLight over the packed (1 + P + S, 12) light rows."""
    r = rows[light_index]
    kind = r[..., 0]
    radiance = r[..., 1:4]
    sun_l = -_norm(r[..., 4:7])
    to_light = r[..., 4:7] - pos_ws
    d2 = (to_light * to_light).sum(-1)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
    pl = to_light / dist[..., None]
    dpr = dist / torch.clamp_min(r[..., 7], 1e-20)
    dpr2 = dpr * dpr
    radial = torch.clamp(1.0 - dpr2 * dpr2, 0.0, 1.0)
    p_irr = radiance * (radial / torch.clamp_min(d2, 1e-20))[..., None]
    cd = (-r[..., 8:11] * pl).sum(-1)
    ang = torch.clamp(cd * r[..., 7] + r[..., 11], 0.0, 1.0)
    ang = ang * ang
    s_irr = radiance * (ang / torch.clamp_min(d2, 1e-20))[..., None]
    is_sun = kind == 0.0
    is_point = kind == 1.0
    l = torch.where(is_sun[..., None], sun_l, pl)
    d = torch.where(is_sun, 100.0, dist)
    irr = torch.where(
        is_sun[..., None], radiance,
        torch.where(is_point[..., None], p_irr, s_irr),
    )
    return l, d, irr


def sample_light(lights: dict, light_index, pos_ws):
    """Uniform light pick: 0 = sun, then points, then spots
    (lighting.glsl:57-88), over the packed light rows that
    scene.lights.light_uniforms always provides. Returns (l, dist,
    irradiance)."""
    return sample_light_packed(lights["packed_rows"], light_index, pos_ws)
