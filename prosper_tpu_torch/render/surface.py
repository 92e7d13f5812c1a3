"""Hit -> visible surface.

Counterpart of prosper_tpu/render/surface.py `evaluate_surface_from_attrs`
(:72), `evaluate_surface` (:152), `mapped_normal` (:20),
`pixel_cone_alpha` (:28), `cone_lod` (:33) and `_aniso_footprint` (:45):
surfaces from the full trace kernels' interpolated world-space
attributes, or from a (t, tri, u, v) hit by gathering the triangle's
vertex attributes and instance transforms. A ray cone (the G-buffer's
pixel spread) selects the texture LOD, as the raster path's derivatives
do in the reference: trilinear taps, or with cone["aniso_taps"] > 1
anisotropic taps along the footprint's major axis; without a cone the
base mip, and fixed_mip one mip for every texture. On an arena whose
textures all have one mip (arena["one_mip"], scene/convert.py; every
procedural scene) the trilinear tap's LOD clamps to 0 and selects the
base mip exactly, so an isotropic cone samples it directly.
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


def _mip_cone(arena: dict, cone: dict | None) -> dict | None:
    """The cone, or None where it selects the base mip exactly: an
    isotropic cone over an arena of one-mip textures."""
    if (cone is not None and arena.get("one_mip", False)
            and int(cone.get("aniso_taps", 1)) <= 1):
        return None
    return cone


def _aniso_footprint(cone, ray_d, n_ws, t_hit, e1w, e2w, uve1, uve2):
    """Anisotropic ray-cone footprint (maxAnisotropy 16): the minor axis
    is the cone width, the major width / cos(theta) along the in-plane
    view direction (ratio clamped to 16); the world major axis maps to uv
    through the triangle's edge Gram solve. Returns (duv_major (R, 2),
    log2(width_minor))."""
    cosd = (ray_d * n_ws).sum(-1).abs()
    t_safe = torch.where(torch.isfinite(t_hit), t_hit, 0.0)
    w_minor = torch.clamp_min(t_safe, 1e-6) * cone["alpha"]
    ratio = torch.clamp(1.0 / torch.clamp_min(cosd, 1e-3), 1.0, 16.0)
    mdir = ray_d - n_ws * (ray_d * n_ws).sum(-1)[..., None]
    mdir = mdir / torch.clamp_min(
        (mdir * mdir).sum(-1, keepdim=True).sqrt(), 1e-9)
    vec = mdir * (w_minor * ratio)[..., None]
    g11 = (e1w * e1w).sum(-1)
    g12 = (e1w * e2w).sum(-1)
    g22 = (e2w * e2w).sum(-1)
    det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-20)
    b1 = (e1w * vec).sum(-1)
    b2 = (e2w * vec).sum(-1)
    x = (g22 * b1 - g12 * b2) / det
    y = (g11 * b2 - g12 * b1) / det
    duv_major = x[..., None] * uve1 + y[..., None] * uve2
    return duv_major, torch.log2(torch.clamp_min(w_minor, 1e-8))


def evaluate_surface_from_attrs(arena: dict, ray_o, ray_d, hit: dict,
                                cone: dict | None = None, tris_packed=None,
                                fixed_mip: int | None = None) -> dict:
    """VisibleSurface dict from a full hit dict (normal, tangent, uv,
    material, t, tri, tri_lod): position, shading normal, material terms,
    NoV.

    cone ({"alpha", "bias", "aniso_taps"}) selects the LOD by cone_lod;
    with aniso_taps > 1 and the 40-row slabs `tris_packed`, the winning
    triangle's world and uv edges (rows 3:9, 30:36) give the anisotropic
    footprint. fixed_mip samples every texture at that mip."""
    cone = _mip_cone(arena, cone)
    n_ws = _normalize(hit["normal"])
    t_ws = _normalize(hit["tangent"][..., :3])
    t_sign = hit["tangent"][..., 3]
    uv = hit["uv"]
    material = hit["material"]
    position = ray_o + hit["t"][..., None] * ray_d
    lod, duv_major = None, None
    aniso_taps = int((cone or {}).get("aniso_taps", 1))
    if (aniso_taps > 1 and cone is not None and tris_packed is not None
            and "tri_lod" in hit):
        tri = torch.clamp_min(hit["tri"], 0).long()
        a = tris_packed[tri // 128, :, tri % 128][
            :, [3, 4, 5, 6, 7, 8, 30, 31, 32, 33, 34, 35]]
        uv0, uv1, uv2 = a[:, 6:8], a[:, 8:10], a[:, 10:12]
        duv_major, lod_minor = _aniso_footprint(
            cone, ray_d, n_ws, hit["t"], a[:, 0:3], a[:, 3:6], uv1 - uv0,
            uv2 - uv0)
        lod = hit["tri_lod"] + lod_minor + cone.get("bias", 0.0)
    elif cone is not None and "tri_lod" in hit:
        lod = cone_lod(hit, ray_d, n_ws, cone)
    mat = sample_material_packed(
        arena, material, uv, lod, duv_major=duv_major,
        aniso_taps=aniso_taps if lod is not None else 1,
        fixed_mip=fixed_mip)
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
    the instance's transforms, the material sampled at the ray cone's
    LOD (the triangle's uv density from its gathered world and uv edges;
    anisotropic with cone["aniso_taps"] > 1), else at the base mip. A
    miss (tri < 0) gives finite values of triangle 0 that callers mask.
    Returns the keys of evaluate_surface_from_attrs and "instance"."""
    cone = _mip_cone(arena, cone)
    tri = torch.clamp_min(hit["tri"], 0).long()
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = 1.0 - u - v
    aidx = static["wt_aidx"][tri].long()
    ap = static["a_packed"]
    a0, a1, a2 = ap[aidx[:, 0]], ap[aidx[:, 1]], ap[aidx[:, 2]]
    ai = w * a0 + u * a1 + v * a2
    inst = static["wt_instance"][tri]
    m = frame["transforms"][inst]
    n_ws = _normalize(_xf(frame["normal_transforms"][inst], ai[:, 0:3]))
    t_ws = _normalize(_xf(m, ai[:, 3:6]))
    t_sign = ai[:, 6]
    uv = ai[:, 7:9]
    material = static["wt_material"][tri]
    lod, duv_major = None, None
    aniso_taps = int((cone or {}).get("aniso_taps", 1))
    if cone is not None:
        p0 = static["wt_p0"][tri]
        e1w = _xf(m, static["wt_p1"][tri] - p0)
        e2w = _xf(m, static["wt_p2"][tri] - p0)
        w_area = torch.linalg.cross(e1w, e2w).pow(2).sum(-1).sqrt()
        uve1 = a1[:, 7:9] - a0[:, 7:9]
        uve2 = a2[:, 7:9] - a0[:, 7:9]
        uv_area = torch.abs(uve1[:, 0] * uve2[:, 1] - uve1[:, 1] * uve2[:, 0])
        tri_lod = 0.5 * torch.log2(torch.clamp_min(uv_area, 1e-20)
                                   / torch.clamp_min(w_area, 1e-20))
        if aniso_taps > 1:
            duv_major, lod_minor = _aniso_footprint(
                cone, ray_d, n_ws, hit["t"], e1w, e2w, uve1, uve2)
            lod = tri_lod + lod_minor + cone.get("bias", 0.0)
        else:
            lod = cone_lod({"tri_lod": tri_lod, "t": hit["t"]}, ray_d, n_ws,
                           cone)
    mat = sample_material_packed(arena, material, uv, lod,
                                 duv_major=duv_major, aniso_taps=aniso_taps)
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
