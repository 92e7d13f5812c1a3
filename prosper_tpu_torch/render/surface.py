"""Hit -> visible surface.

Counterpart of prosper_tpu/render/surface.py `evaluate_surface_from_attrs`
(:72), `evaluate_surface` (:152), `mapped_normal` (:20),
`pixel_cone_alpha` (:28) and `cone_lod` (:33): surfaces from the full
trace kernels' interpolated world-space attributes, or from a (t, tri,
u, v) hit by gathering the triangle's vertex attributes and instance
transforms; materials sampled at the base mip.

The G-buffer passes a ray cone (texture LOD from the pixel footprint).
The port has the base mip only (ROADMAP.md queue 1, "Scene path without
JAX"), and the base mip is what the cone selects exactly when every
texture of the arena has one mip, as in every procedural scene: the JAX
trilinear tap clamps its LOD to [0, n_mips - 1]. On an arena with more
mips a cone raises instead of sampling mip 0 silently.
"""

from __future__ import annotations

import torch

from ..ops.texture import sample_material_packed


def _normalize(v):
    return v / torch.clamp_min((v * v).sum(-1, keepdim=True).sqrt(), 1e-20)


def mapped_normal(normal_ts, n, t, sgn):
    """Tangent-space normal -> world (main.rgen:37-45)."""
    b = sgn[..., None] * torch.linalg.cross(n, t)
    return _normalize(
        normal_ts[..., 0:1] * t + normal_ts[..., 1:2] * b + normal_ts[..., 2:3] * n
    )


def pixel_cone_alpha(cam: dict, height: int):
    """Per-pixel ray-cone spread angle: 2 * tan(fov / 2) / height."""
    return 2.0 / (cam["camera_to_clip"][1, 1].abs() * height)


def cone_lod(hit: dict, ray_d, n_ws, cone: dict):
    """Ray-cone texture LOD, log2 of the footprint in texels of a unit
    texture: footprint = t * pixel spread / |cos theta| with the
    triangle's uv density hit["tri_lod"] and cone = {"alpha": pixel
    spread, "bias": lodBias}."""
    cosd = (ray_d * n_ws).sum(-1).abs()
    t_hit = torch.where(torch.isfinite(hit["t"]), hit["t"], 0.0)
    width = (torch.clamp_min(t_hit, 1e-6) * cone["alpha"]
             / torch.clamp_min(cosd, 0.05))
    return hit["tri_lod"] + torch.log2(width) + cone.get("bias", 0.0)


def _check_cone(arena: dict, cone: dict) -> None:
    """Refuse a cone the base-mip path cannot honour exactly."""
    if int(cone.get("aniso_taps", 1)) > 1:
        raise NotImplementedError(
            "aniso_taps > 1 needs the anisotropic taps: ROADMAP.md queue "
            "1, item 'Scene path without JAX'"
        )
    # n_mips stays on the host (scene/convert.py): no device wait here
    if int(arena["n_mips"].max()) > 1:
        raise NotImplementedError(
            "ray-cone LOD on a multi-mip texture arena needs trilinear "
            "taps: ROADMAP.md queue 1, item 'Scene path without JAX'"
        )


def evaluate_surface_from_attrs(arena: dict, ray_o, ray_d, hit: dict,
                                cone: dict | None = None) -> dict:
    """VisibleSurface dict from a full hit dict (normal, tangent, uv,
    material, t, tri): position, shading normal, material terms, NoV.

    cone ({"alpha", "bias", "aniso_taps"}, as the JAX G-buffer passes
    it) is accepted on one-mip arenas, where it selects the base mip."""
    if cone is not None:
        _check_cone(arena, cone)
    n_ws = _normalize(hit["normal"])
    t_ws = _normalize(hit["tangent"][..., :3])
    t_sign = hit["tangent"][..., 3]
    uv = hit["uv"]
    material = hit["material"]
    position = ray_o + hit["t"][..., None] * ray_d
    mat = sample_material_packed(arena, material, uv)
    has_map = (mat["normal_ts"][..., 0] != -2.0) & (t_sign != 0.0)
    n_mapped = mapped_normal(mat["normal_ts"], n_ws, t_ws, t_sign)
    normal_ws = torch.where(has_map[..., None], n_mapped, n_ws)
    inv_view = -ray_d
    NoV = torch.clamp((normal_ws * inv_view).sum(-1), 0.0, 1.0)
    return {
        "valid": hit["tri"] >= 0,
        "position_ws": position,
        "normal_ws": normal_ws,
        "uv": uv,
        "albedo": mat["albedo"],
        "alpha": mat["alpha"],
        "roughness": mat["roughness"],
        "metallic": mat["metallic"],
        "material": material,
        "inv_view_ray": inv_view,
        "NoV": NoV,
        "linear_depth": hit["t"],
    }


def _xf(m, v):
    """Per-row linear map: m (R, 3, >=3), v (R, 3) -> (R, 3)."""
    return (m[:, :, :3] * v[:, None, :]).sum(-1)


def evaluate_surface(static: dict, frame: dict, arena: dict, ray_o, ray_d,
                     hit: dict, cone: dict | None = None) -> dict:
    """VisibleSurface dict from a (t, tri, u, v) hit (ops/slabs.
    unpack_hit8): the triangle's three vertex rows of a_packed
    interpolated as w*a0 + u*a1 + v*a2, the normal and tangent through
    the instance's transforms, the material sampled at the base mip. A
    miss (tri < 0) gives finite values of triangle 0 that callers mask.

    cone is accepted on one-mip arenas, as in
    evaluate_surface_from_attrs. Returns the keys of
    evaluate_surface_from_attrs and "instance"."""
    if cone is not None:
        _check_cone(arena, cone)
    tri = torch.clamp_min(hit["tri"], 0).long()
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v
    aidx = static["wt_aidx"][tri].long()
    ap = static["a_packed"]
    ai = w * ap[aidx[:, 0]] + u * ap[aidx[:, 1]] + v * ap[aidx[:, 2]]
    inst = static["wt_instance"][tri]
    n_ws = _normalize(_xf(frame["normal_transforms"][inst], ai[:, 0:3]))
    t_ws = _normalize(_xf(frame["transforms"][inst], ai[:, 3:6]))
    t_sign = ai[:, 6]
    uv = ai[:, 7:9]
    material = static["wt_material"][tri]
    mat = sample_material_packed(arena, material, uv)
    has_map = (mat["normal_ts"][:, 0] != -2.0) & (t_sign != 0.0)
    n_mapped = mapped_normal(mat["normal_ts"], n_ws, t_ws, t_sign)
    normal_ws = torch.where(has_map[:, None], n_mapped, n_ws)
    inv_view = -ray_d
    return {
        "valid": hit["tri"] >= 0,
        "position_ws": ray_o + hit["t"][:, None] * ray_d,
        "normal_ws": normal_ws,
        "uv": uv,
        "albedo": mat["albedo"],
        "alpha": mat["alpha"],
        "roughness": mat["roughness"],
        "metallic": mat["metallic"],
        "material": material,
        "instance": inst,
        "inv_view_ray": inv_view,
        "NoV": torch.clamp((normal_ws * inv_view).sum(-1), 0.0, 1.0),
        "linear_depth": hit["t"],
    }
