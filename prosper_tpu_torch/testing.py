"""Procedural scenes as numpy dicts.

Counterpart of prosper_tpu/testing.py. Both scene functions return
(static, frame, arena, cam_fn) in the layout of
`prosper_tpu.testing.make_test_scene`, so either package can consume
them: `static` holds the object-space triangle arena and materials,
`frame` the per-frame AABBs, BVH2 node arrays and light uniforms,
`arena` a 1-px white texture arena (plus an alpha checker where a plate
scene has alpha-masked plates), and `cam_fn(w, h)` camera uniforms.
"""

from __future__ import annotations

import numpy as np

from .accel.bvh import build_bvh, pack_nodes
from .scene.camera import Camera, CameraParameters, CameraTransform
from .scene.lights import MAX_POINT_LIGHTS, LightArrays, light_uniforms

CLUSTER_TRI_PAD = 128  # triangles per cluster slab (scene/meshlets.py)


def _white_arena() -> dict:
    """1 px white default texture arena (quad layout)."""
    return {
        "data": np.full((1, 4), 0xFFFFFFFF, np.uint32),
        "table": np.zeros((1, 13, 4), np.int32)
        + np.array([0, 1, 1, 0], np.int32)[None, None, :],
        "n_mips": np.ones(1, np.int32),
    }


def _rgba8_quads(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) u8 -> (H*W, 4) u32 bilinear quads: texel (x, y) and its
    +x, +y, +xy REPEAT neighbours (prosper_tpu/scene/textures.py
    pack_rgba8_quads)."""
    i = img.astype(np.uint32)
    grid = i[..., 0] | (i[..., 1] << 8) | (i[..., 2] << 16) | (i[..., 3] << 24)
    xr = np.roll(grid, -1, axis=1)
    yr = np.roll(grid, -1, axis=0)
    xyr = np.roll(xr, -1, axis=0)
    return np.stack([grid.reshape(-1), xr.reshape(-1), yr.reshape(-1),
                     xyr.reshape(-1)], axis=1)


def _checker_arena(n: int = 4) -> dict:
    """The white arena plus texture 1: an n x n white sRGB texture whose
    alpha is a checker of 255 and 0, one mip, REPEAT wrap. Bilinear taps
    blend the cells, so an alpha cutoff of 0.5 keeps about half of it."""
    arena = _white_arena()
    img = np.full((n, n, 4), 255, np.uint8)
    y, x = np.mgrid[0:n, 0:n]
    img[..., 3] = np.where((x + y) % 2 == 0, 255, 0)
    table = np.concatenate(
        [arena["table"], np.zeros((1, 13, 4), np.int32)
         + np.array([1, n, n, 1], np.int32)[None, None, :]])
    return {
        "data": np.concatenate([arena["data"], _rgba8_quads(img)]),
        "table": table,
        "n_mips": np.ones(2, np.int32),
    }


def _cam_fn(eye, target):
    def cam_fn(width: int, height: int) -> dict:
        cam = Camera(
            (width, height),
            CameraParameters(),
            CameraTransform(
                eye=np.asarray(eye, np.float32),
                target=np.asarray(target, np.float32),
                up=np.array([0.0, 1.0, 0.0], np.float32),
            ),
        )
        return cam.uniforms()

    return cam_fn


def make_test_scene(n_boxes: int = 4, seed: int = 0):
    """A grid of axis-aligned boxes (12 tris each), one cluster per box.
    A line-for-line copy of prosper_tpu.testing.make_test_scene."""
    rng = np.random.default_rng(seed)
    pad = CLUSTER_TRI_PAD

    corners = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32
    )
    faces = [
        (0, 1, 3, 2),  # x=0
        (4, 6, 7, 5),  # x=1
        (0, 4, 5, 1),  # y=0
        (2, 3, 7, 6),  # y=1
        (0, 2, 6, 4),  # z=0
        (1, 5, 7, 3),  # z=1
    ]
    tris = []
    for a, b, c, d in faces:
        tris.append((a, b, c))
        tris.append((a, c, d))
    tris = np.array(tris, np.int32)

    n_clusters = n_boxes
    S = n_clusters * pad
    wt_p0 = np.zeros((S, 3), np.float32)
    wt_p1 = np.zeros((S, 3), np.float32)
    wt_p2 = np.zeros((S, 3), np.float32)
    wt_aidx = np.zeros((S, 3), np.int32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)

    a_normal = []
    a_tangent = []
    a_uv = []
    v_off = 0
    for b in range(n_boxes):
        origin = np.array([(b % 2) * 2.0 - 1.0, 0.0, (b // 2) * 2.0 - 1.0]) * 1.5
        verts = corners * 0.8 + origin
        base = b * pad
        wt_p0[base : base + 12] = verts[tris[:, 0]]
        wt_p1[base : base + 12] = verts[tris[:, 1]]
        wt_p2[base : base + 12] = verts[tris[:, 2]]
        wt_aidx[base : base + 12] = tris + v_off
        wc_min[b] = verts.min(axis=0)
        wc_max[b] = verts.max(axis=0)
        n = verts - verts.mean(axis=0)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        a_normal.append(n.astype(np.float32))
        t = np.cross(np.array([0.0, 1.0, 0.0]), n)
        t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-9)
        a_tangent.append(
            np.concatenate([t, np.ones((8, 1))], axis=1).astype(np.float32)
        )
        a_uv.append(rng.random((8, 2), dtype=np.float32))
        v_off += 8

    materials = {
        "base_color_factor": np.array(
            [[1, 1, 1, 1], [0.8, 0.4, 0.3, 1.0]], np.float32
        ),
        "metallic_factor": np.array([1.0, 0.1], np.float32),
        "roughness_factor": np.array([1.0, 0.7], np.float32),
        "alpha_cutoff": np.array([0.5, 0.5], np.float32),
        "alpha_mode": np.array([0, 0], np.int32),
        "base_color_tex": np.array([0, 0], np.int32),
        "metallic_roughness_tex": np.array([0, 0], np.int32),
        "normal_tex": np.array([0, 0], np.int32),
    }

    wc_center = (wc_min + wc_max) / 2
    wc_radius = np.linalg.norm(wc_max - wc_center, axis=1).astype(np.float32)
    static = {
        "wc_instance": np.zeros(n_clusters, np.int32),
        "wc_material": np.ones(n_clusters, np.int32),
        "wc_sphere_center": wc_center.astype(np.float32),
        "wc_sphere_radius": wc_radius,
        "wc_cone_axis": np.tile(np.array([[0, 0, 1.0]], np.float32), (n_clusters, 1)),
        "wc_cone_cutoff": np.ones(n_clusters, np.float32),  # never cone-cull
        "wc_tri_count": np.full(n_clusters, 12, np.int32),
        "wt_p0": wt_p0,
        "wt_p1": wt_p1,
        "wt_p2": wt_p2,
        "wt_aidx": wt_aidx,
        "wt_instance": np.zeros(S, np.int32),
        "wt_material": np.ones(S, np.int32),
        "a_packed": np.concatenate(
            [
                np.concatenate(
                    [n, t, uv, np.zeros((len(n), 3), np.float32)], axis=1
                )
                for n, t, uv in zip(a_normal, a_tangent, a_uv)
            ]
        ),
        "materials": materials,
    }

    bvh = build_bvh(wc_min, wc_max, max_leaf_size=1)
    lights = LightArrays()
    lights.point_radiance[0] = [30.0, 25.0, 20.0]
    lights.point_position[0] = [0.0, 3.0, 0.0]
    lights.point_radius[0] = 50.0
    lights.point_count = 1

    frame = {
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "transforms": np.eye(4, dtype=np.float32)[None, :3, :4],
        "normal_transforms": np.eye(3, dtype=np.float32)[None],
        "bvh_bounds": pack_nodes(bvh)[0],
        "bvh_meta": pack_nodes(bvh)[1],
        "lights": light_uniforms(lights),
    }
    cam_fn = _cam_fn([4.0, 3.5, 4.5], [0.0, 0.3, 0.0])
    return static, frame, _white_arena(), cam_fn


def make_plate_scene(n_clusters: int = 2048, seed: int = 0,
                     scatter_lights: int = 0, blend_every: int = 0,
                     mask_every: int = 0):
    """The geometry of prosper_tpu.testing.make_stress_scene completed
    into a full scene: n_clusters plates of 128 triangles (8x8 quad
    grids), randomly rotated in a 3D grid of 1.5 spacing — 262,144
    triangles at 2048 clusters ("Sponza-class", BASELINE config 2).

    The triangles equal make_stress_scene's for the same arguments. The
    completion adds per-vertex normal/tangent/uv rows (`a_packed`,
    `wt_aidx`), cluster data, two materials (a rough dielectric and a
    metal, alternating by cluster), the default sun plus one point light
    above the grid, the 1-px white arena, and a camera outside the grid
    aimed at its centre.

    scatter_lights > 0 replaces the point light by that many (at most
    1024) scattered ones, the CLI's many-light recipe
    (prosper_tpu/app/cli.py:340-351, bench.py:246-256): default_rng(0),
    positions uniform in the scene bounds, radiance U(0.05, 0.5) per
    channel, radius the bounds' diagonal.

    blend_every = k > 0 gives every k-th cluster (ci % k == k - 1) a
    third material, alpha-blended (alpha_mode 2) with base alpha 0.5;
    mask_every = k > 0 gives the clusters at ci % k == k // 2 a fourth,
    alpha-masked (alpha_mode 1, cutoff 0.5) through a 4x4 alpha checker
    texture, so the mask discards part of each such plate (the mask wins
    where both rules pick a cluster). With either option both materials
    and the checker texture are in the scene."""
    rng = np.random.default_rng(seed)
    pad = CLUSTER_TRI_PAD
    g = 8  # 8x8 quads -> 128 tris, a full cluster
    nv = (g + 1) * (g + 1)

    side = int(np.ceil(n_clusters ** (1.0 / 3.0)))
    S = n_clusters * pad
    p0 = np.zeros((S, 3), np.float32)
    p1 = np.zeros((S, 3), np.float32)
    p2 = np.zeros((S, 3), np.float32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)
    a_packed = np.zeros((n_clusters * nv, 12), np.float32)

    xs, ys = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    verts = np.stack(
        [xs.ravel() / g, ys.ravel() / g, np.zeros((g + 1) * (g + 1))], 1
    ).astype(np.float32)
    quads = []
    for i in range(g):
        for j in range(g):
            a = i * (g + 1) + j
            b = a + 1
            c = a + (g + 1)
            d = c + 1
            quads += [(a, b, c), (b, d, c)]
    tris_local = np.array(quads, np.int32)

    for ci in range(n_clusters):
        cell = np.array(
            [ci % side, (ci // side) % side, ci // (side * side)], np.float32
        )
        origin = cell * 1.5 + rng.uniform(-0.2, 0.2, 3)
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        v = verts @ rot.T + origin
        base = ci * pad
        p0[base : base + 128] = v[tris_local[:, 0]]
        p1[base : base + 128] = v[tris_local[:, 1]]
        p2[base : base + 128] = v[tris_local[:, 2]]
        wc_min[ci] = v.min(axis=0)
        wc_max[ci] = v.max(axis=0)
        # local frame: normal = +z, tangent = +x (the u axis); a
        # reflection in `rot` flips the bitangent, hence the sign
        rows = a_packed[ci * nv : (ci + 1) * nv]
        rows[:, 0:3] = rot[:, 2]
        rows[:, 3:6] = rot[:, 0]
        rows[:, 6] = np.sign(np.linalg.det(rot))
        rows[:, 7:9] = verts[:, 0:2]

    aidx = (
        tris_local[None, :, :] + (np.arange(n_clusters) * nv)[:, None, None]
    ).reshape(S, 3).astype(np.int32)
    ci = np.arange(n_clusters)
    cluster_mat = (ci % 2).astype(np.int32)
    # opaque rough dielectric, opaque metal, then blend and mask
    materials = {
        "base_color_factor": np.array(
            [[0.8, 0.8, 0.75, 1.0], [0.95, 0.64, 0.54, 1.0],
             [0.25, 0.45, 0.95, 0.5], [0.35, 0.75, 0.4, 1.0]], np.float32
        ),
        "metallic_factor": np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        "roughness_factor": np.array([0.6, 0.35, 0.3, 0.5], np.float32),
        "alpha_cutoff": np.full(4, 0.5, np.float32),
        "alpha_mode": np.array([0, 0, 2, 1], np.int32),
        "base_color_tex": np.array([0, 0, 0, 1], np.int32),
        "metallic_roughness_tex": np.zeros(4, np.int32),
        "normal_tex": np.zeros(4, np.int32),
    }
    if blend_every > 0:
        cluster_mat[ci % blend_every == blend_every - 1] = 2
    if mask_every > 0:
        cluster_mat[ci % mask_every == mask_every // 2] = 3
    alpha = blend_every > 0 or mask_every > 0
    if not alpha:
        materials = {k: v[:2] for k, v in materials.items()}
    wc_center = (wc_min + wc_max) / 2
    wc_radius = np.linalg.norm(wc_max - wc_center, axis=1).astype(np.float32)
    static = {
        "wc_instance": np.zeros(n_clusters, np.int32),
        "wc_material": cluster_mat,
        "wc_sphere_center": wc_center.astype(np.float32),
        "wc_sphere_radius": wc_radius,
        "wc_cone_axis": a_packed[::nv, 0:3].copy(),
        "wc_cone_cutoff": np.ones(n_clusters, np.float32),  # never cone-cull
        "wc_tri_count": np.full(n_clusters, 128, np.int32),
        "wt_p0": p0,
        "wt_p1": p1,
        "wt_p2": p2,
        "wt_aidx": aidx,
        "wt_instance": np.zeros(S, np.int32),
        "wt_material": np.repeat(cluster_mat, pad),
        "a_packed": a_packed,
        "materials": materials,
    }

    lo = wc_min.min(axis=0)
    hi = wc_max.max(axis=0)
    center = (lo + hi) / 2
    ext = float(np.max(hi - lo))
    lights = LightArrays()
    lights.point_position[0] = center + np.array([0.0, 0.75 * ext, 0.0])
    lights.point_radiance[0] = np.array([1.0, 0.9, 0.8]) * ext * ext
    lights.point_radius[0] = 4.0 * ext
    lights.point_count = 1
    if scatter_lights > 0:
        lrng = np.random.default_rng(0)
        n = min(scatter_lights, MAX_POINT_LIGHTS)
        lights.point_position[:n] = lrng.uniform(lo, hi, (n, 3))
        lights.point_radiance[:n] = lrng.uniform(0.05, 0.5, (n, 3))
        lights.point_radius[:n] = float(np.linalg.norm(hi - lo))
        lights.point_count = n

    bounds, meta = pack_nodes(build_bvh(wc_min, wc_max, max_leaf_size=1))
    frame = {
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "transforms": np.eye(4, dtype=np.float32)[None, :3, :4],
        "normal_transforms": np.eye(3, dtype=np.float32)[None],
        "bvh_bounds": bounds,
        "bvh_meta": meta,
        "lights": light_uniforms(lights),
    }
    view = np.array([1.0, 0.7, 1.2])
    eye = center + view / np.linalg.norm(view) * 0.9 * ext
    arena = _checker_arena() if alpha else _white_arena()
    return static, frame, arena, _cam_fn(eye, center)
