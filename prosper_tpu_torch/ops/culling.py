"""GPU-driven meshlet culling as masks over flat cluster arrays.

Counterpart of prosper_tpu/ops/culling.py (:28-214), the reference's
draw_list_culler.comp: world-space bounding spheres against the six
frustum planes, the meshoptimizer cone test, and the Mara-McGuire
projected-sphere test against the previous frame's HiZ pyramid
(reverse-z min of a 2x2 footprint at the sphere's mip). The masks are
booleans over clusters; the draw lists of the reference become the mask
and its count.
"""

from __future__ import annotations

import numpy as np
import torch

from .hiz import hiz_dimensions


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _sd(plane, p):
    """dot(plane, vec4(p, 1)) (draw_list_culler.comp:57)."""
    return (p * plane[..., :3]).sum(-1) + plane[..., 3]


def transform_cluster_bounds(static_scene: dict, frame: dict, uniform_scales):
    """Object-space meshlet bounds -> world space (transformBounds)."""
    inst = static_scene["wc_instance"].long()
    m = frame["transforms"][inst]  # (C, 3, 4)
    center = (m[:, :, :3] * static_scene["wc_sphere_center"][:, None, :]).sum(
        -1) + m[:, :, 3]
    radius = (static_scene["wc_sphere_radius"] * uniform_scales[inst]).abs()
    axis = (m[:, :, :3] * static_scene["wc_cone_axis"][:, None, :]).sum(-1)
    axis = axis / torch.clamp_min(_norm(axis)[:, None], 1e-20)
    return center, radius, axis, static_scene["wc_cone_cutoff"]


def sphere_outside_frustum(center, radius, frustum_planes):
    """(C,) true when fully outside any of the 6 planes."""
    d = torch.stack([_sd(frustum_planes[i], center) for i in range(6)], -1)
    return (d < -radius[..., None]).any(dim=-1)


def cone_cap_hidden(center, radius, axis, cutoff, eye):
    """meshoptimizer cone test (draw_list_culler.comp:186-192)."""
    to_c = center - eye
    return (to_c * axis).sum(-1) >= cutoff * _norm(to_c) + radius


def project_sphere_view(c, r, znear, p00, p11):
    """Projected sphere uv AABB (draw_list_culler.comp:79-105). c: view
    centre with +z into the screen. Returns (valid, aabb (..., 4) minx
    miny maxx maxy in uv)."""
    valid = c[..., 2] >= r + znear
    cz = torch.where(valid, c[..., 2], 1.0)
    crx = c[..., 0] * r
    cry = c[..., 1] * r
    crz = cz * r
    czr2 = cz * cz - r * r
    vx = torch.sqrt(torch.clamp_min(c[..., 0] ** 2 + czr2, 0.0))
    minx = (vx * c[..., 0] - crz) / (vx * cz + crx)
    maxx = (vx * c[..., 0] + crz) / (vx * cz - crx)
    vy = torch.sqrt(torch.clamp_min(c[..., 1] ** 2 + czr2, 0.0))
    miny = (vy * c[..., 1] - crz) / (vy * cz + cry)
    maxy = (vy * c[..., 1] + crz) / (vy * cz - cry)
    aabb = torch.stack([
        minx * p00 * 0.5 + 0.5,
        maxy * p11 * -0.5 + 0.5,
        maxx * p00 * 0.5 + 0.5,
        miny * p11 * -0.5 + 0.5,
    ], -1)
    return valid, aabb


def _project(m, p):
    """[p, 1] @ m.T for a (4, 4) matrix, summed as the JAX package does."""
    return torch.cat([p, torch.ones_like(p[..., :1])], -1) @ m.T


def sphere_occluded(center, radius, cam: dict, hiz_mips: list, width: int,
                    height: int):
    """HiZ occlusion test (isSphereOccluded); nothing is occluded without
    a pyramid. Each cluster reads the 2x2 footprint at its own mip, from
    the mips laid end to end in one flat tensor: one gather, where the
    JAX package tests every mip and selects (the same values, ~60 fewer
    launches a mip)."""
    if not hiz_mips:
        return torch.zeros(center.shape[:-1], dtype=torch.bool,
                           device=center.device)
    hw, hh = hiz_dimensions(width, height)
    n_mips = len(hiz_mips)
    for m, hz in enumerate(hiz_mips):  # build_hiz's halving pyramid
        if tuple(hz.shape) != (hh >> m, hw >> m):
            raise ValueError(f"HiZ mip {m} is {tuple(hz.shape)}, not "
                             f"{(hh >> m, hw >> m)}")
    w2c = cam["world_to_camera"]
    c_view = center @ w2c[:3, :3].T + w2c[:3, 3]
    conservative_r = radius * cam["max_view_scale"]
    c_pos = torch.stack([c_view[..., 0], c_view[..., 1], -c_view[..., 2]], -1)
    p00 = cam["camera_to_clip"][0, 0]
    p11 = cam["camera_to_clip"][1, 1]
    valid, aabb = project_sphere_view(c_pos, conservative_r, cam["near"],
                                      p00, p11)
    # products with Python scalars: a tensor built from a list would be a
    # host-to-device copy, which waits for the device
    ext = aabb[..., 2:4] - aabb[..., 0:2]
    px_diameter = _norm(torch.stack([ext[..., 0] * width,
                                     ext[..., 1] * height], -1))
    mip = torch.clamp(
        torch.floor(torch.log2(torch.clamp_min(px_diameter, 1e-6))),
        0, n_mips - 1,
    ).to(torch.int64)
    # a sphere that is not valid is never occluded; mip 0 keeps its reads
    # in range whatever its (possibly non-finite) diameter
    mip = torch.where(valid, mip, 0)

    # closest depth on the sphere toward the camera
    view_dir = cam["eye"] - center
    view_dir = view_dir / torch.clamp_min(_norm(view_dir)[..., None], 1e-20)
    closest_ws = center + view_dir * radius[..., None]
    w2clip = cam["camera_to_clip"] @ cam["world_to_camera"]
    clip = _project(w2clip, closest_ws)
    closest_depth = clip[..., 2] / clip[..., 3]

    cclip = _project(w2clip, center)
    uv = (cclip[..., :2] / cclip[..., 3:4]) * 0.5 + 0.5
    u = uv[..., 0] * float(np.float32(width / (hw * 2)))
    v = uv[..., 1] * float(np.float32(height / (hh * 2)))

    # the cluster's mip: its size and its offset in the flat pyramid
    mw = torch.full_like(mip, hw) >> mip
    mh = torch.full_like(mip, hh) >> mip
    levels = torch.arange(n_mips, device=mip.device)
    sizes = (torch.full_like(levels, hh) >> levels) * (
        torch.full_like(levels, hw) >> levels)
    offset = (torch.cumsum(sizes, 0) - sizes)[mip]
    flat = torch.cat([hz.reshape(-1) for hz in hiz_mips])
    x0 = torch.floor(u * mw.to(u.dtype) - 0.5).to(torch.int64)
    y0 = torch.floor(v * mh.to(v.dtype) - 0.5).to(torch.int64)

    def fetch(yi, xi):
        inside = (yi >= 0) & (yi < mh) & (xi >= 0) & (xi < mw)
        yc = torch.minimum(torch.clamp_min(yi, 0), mh - 1)
        xc = torch.minimum(torch.clamp_min(xi, 0), mw - 1)
        depth = flat[offset + yc * mw + xc]
        return torch.where(inside, depth, 1.0)  # border 1 (near) never culls

    hiz_depth = torch.minimum(
        torch.minimum(fetch(y0, x0), fetch(y0, x0 + 1)),
        torch.minimum(fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)),
    )
    return valid & (closest_depth < hiz_depth)


def cull_clusters(static_scene: dict, frame: dict, cam: dict, uniform_scales,
                  hiz_mips: list, width: int, height: int,
                  output_second_phase: bool = False) -> dict:
    """First/second-phase cluster cull -> {"visible" (C,) bool,
    "visible_count", "drawn_meshlets", "rasterized_triangles"} and, with
    output_second_phase, "second_phase" (C,) bool (the depth-culled
    clusters to re-test) and "second_phase_count". Counts stay on the
    device."""
    center, radius, axis, cutoff = transform_cluster_bounds(
        static_scene, frame, uniform_scales
    )
    scale_ok = uniform_scales[static_scene["wc_instance"].long()] != 0.0
    outside = sphere_outside_frustum(center, radius, cam["frustum_planes"])
    hidden = cone_cap_hidden(center, radius, axis, cutoff, cam["eye"])
    visible = ~outside & ~hidden
    occluded = visible & sphere_occluded(center, radius, cam, hiz_mips,
                                         width, height)
    # zero-scale instances draw unconditionally (the reference skips tests)
    visible = (visible & ~occluded) | ~scale_ok
    count = visible.sum()
    result = {
        "visible": visible,
        "visible_count": count,
        "drawn_meshlets": count,
        "rasterized_triangles": torch.where(
            visible, static_scene["wc_tri_count"], 0).sum(),
    }
    if output_second_phase:
        second = occluded & scale_ok
        result["second_phase"] = second
        result["second_phase_count"] = second.sum()
    return result
