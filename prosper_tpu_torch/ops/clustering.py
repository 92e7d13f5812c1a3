"""Froxel constants and the Doom z-slice helpers.

Counterpart of prosper_tpu/ops/clustering.py :29-44 and :138-143
(light_clusters.glsl:26-50, LightClustering.hpp:25-26 of the
reference): 32 px froxel tiles, 17 logarithmic z-slices over [near,
far], at most 128 point and 128 spot lights per froxel. The clustered
shading kernel (ops/shade_tiles.py) applies the z-slice per pixel, so
the dense froxel lists of `build_light_clusters` are not carried.
"""

from __future__ import annotations

import torch

LIGHT_CLUSTER_DIMENSION = 32
Z_SLICE_COUNT = 17
MAX_POINT_INDICES = 128
MAX_SPOT_INDICES = 128


def slice_starts(near, far):
    """sliceStart of each slice boundary (light_clusters.glsl:28-33)."""
    near = torch.as_tensor(near, dtype=torch.float32)
    frac = torch.arange(Z_SLICE_COUNT + 1, dtype=torch.float32,
                        device=near.device) / Z_SLICE_COUNT
    return near * torch.pow(far / near, frac)


def cluster_index_z(z_cam, near, far):
    """Doom slice index of view-space z (light_clusters.glsl:41-50).

    Clamped before the integer conversion, which equals the reference's
    clamp after truncation for every non-NaN input and keeps z = -inf
    (no surface) defined."""
    ratio = torch.log(torch.clamp_min(-z_cam / near, 1e-20)) / torch.log(
        torch.as_tensor(far / near)
    )
    return torch.clamp(Z_SLICE_COUNT * ratio, 0.0, Z_SLICE_COUNT - 1).to(
        torch.int32
    )
