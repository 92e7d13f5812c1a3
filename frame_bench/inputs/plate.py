"""The plate scene's raw inputs, made from a seed.

A frozen copy of the recipe of `prosper_tpu_torch.testing.make_plate_scene`
(and its helpers `_unit_plate` and `_plate_frames`) as it stood at commit
e89c417: n_clusters plates of 8x8 quads (128 triangles each), randomly
rotated in a 3D grid of 1.5 spacing, two opaque materials alternating by
plate, the default sun, and `scatter_lights` point lights scattered in
the scene bounds with radius the bounds' diagonal.

Only inputs are made here: triangles, vertex rows, materials, raw light
arrays and the camera's eye and target. What the renderer derives from
them (cluster boxes, the BVH, packed light rows, slabs) is left to the
program, and the reference works it out again on its own.

The scattered lights are drawn from `light_seed` (make_plate_scene
always draws them from seed 0; light_seed=0 gives its lights). A
configuration fixes the scene by its `layout_seed`; a run's seed only
reorders its lights (`permuted`), so every seed asks the same work of a
frame.
"""

from __future__ import annotations

import numpy as np

CLUSTER_TRIS = 128  # triangles per plate, one cluster slab
MAX_POINT_LIGHTS = 1024  # the reference renderer's light buffer (Light.hpp:27)

# opaque rough dielectric, opaque metal (make_plate_scene's first two)
MATERIALS = {
    "base_color_factor": np.array([[0.8, 0.8, 0.75, 1.0],
                                   [0.95, 0.64, 0.54, 1.0]], np.float32),
    "metallic_factor": np.array([0.0, 1.0], np.float32),
    "roughness_factor": np.array([0.6, 0.35], np.float32),
    "alpha_cutoff": np.full(2, 0.5, np.float32),
    "alpha_mode": np.zeros(2, np.int32),
    "base_color_tex": np.zeros(2, np.int32),
    "metallic_roughness_tex": np.zeros(2, np.int32),
    "normal_tex": np.zeros(2, np.int32),
}
SUN_IRRADIANCE = np.array([2.0, 2.0, 2.0], np.float32)
SUN_DIRECTION = np.array([-1.0, -1.0, -1.0], np.float32)


def unit_plate(g: int = 8):
    """The (g + 1)^2 vertices (z = 0, the unit square) and 2 g^2
    triangles of one plate."""
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
    return verts, np.array(quads, np.int32)


def plate_frames(n_clusters: int, rng):
    """Each plate's origin (f64) and random rotation (f32, from QR, so it
    may be a reflection): a cell of a side^3 grid of 1.5 spacing,
    jittered by U(-0.2, 0.2)."""
    side = int(np.ceil(n_clusters ** (1.0 / 3.0)))
    origins, rots = [], []
    for ci in range(n_clusters):
        cell = np.array(
            [ci % side, (ci // side) % side, ci // (side * side)], np.float32
        )
        origins.append(cell * 1.5 + rng.uniform(-0.2, 0.2, 3))
        rots.append(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    return origins, rots


def make_plate_inputs(n_clusters: int, seed: int, scatter_lights: int,
                      light_seed: int | None = None) -> dict:
    """The raw inputs of a plate scene.

    Returns a dict of numpy arrays:
    - p0, p1, p2 (S, 3): the triangles' corners, S = n_clusters * 128,
      plate ci's triangles at rows [128 ci, 128 ci + 128);
    - aidx (S, 3) i32: each corner's row of `a_packed`;
    - a_packed (V, 12): normal 3 | tangent 3 | bitangent sign | uv 2 | 0 0 0;
    - tri_material (S,) i32, cluster_material (C,) i32, materials (dict);
    - sun_irradiance, sun_direction (3,);
    - point_position, point_radiance (P, 3), point_radius (P,);
    - eye, target (3,): the camera outside the grid aimed at its centre.
    """
    rng = np.random.default_rng(seed)
    pad = CLUSTER_TRIS
    g = 8
    nv = (g + 1) * (g + 1)

    S = n_clusters * pad
    p0 = np.zeros((S, 3), np.float32)
    p1 = np.zeros((S, 3), np.float32)
    p2 = np.zeros((S, 3), np.float32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)
    a_packed = np.zeros((n_clusters * nv, 12), np.float32)

    verts, tris_local = unit_plate(g)
    for ci, (origin, rot) in enumerate(zip(*plate_frames(n_clusters, rng))):
        v = verts @ rot.T + origin
        base = ci * pad
        p0[base : base + 128] = v[tris_local[:, 0]]
        p1[base : base + 128] = v[tris_local[:, 1]]
        p2[base : base + 128] = v[tris_local[:, 2]]
        wc_min[ci] = v.min(axis=0)
        wc_max[ci] = v.max(axis=0)
        rows = a_packed[ci * nv : (ci + 1) * nv]
        rows[:, 0:3] = rot[:, 2]
        rows[:, 3:6] = rot[:, 0]
        rows[:, 6] = np.sign(np.linalg.det(rot))
        rows[:, 7:9] = verts[:, 0:2]

    aidx = (
        tris_local[None, :, :] + (np.arange(n_clusters) * nv)[:, None, None]
    ).reshape(S, 3).astype(np.int32)
    cluster_mat = (np.arange(n_clusters) % 2).astype(np.int32)

    lo = wc_min.min(axis=0)
    hi = wc_max.max(axis=0)
    center = (lo + hi) / 2
    ext = float(np.max(hi - lo))
    if scatter_lights > 0:
        lrng = np.random.default_rng(0 if light_seed is None else light_seed)
        n = min(scatter_lights, MAX_POINT_LIGHTS)
        point_position = lrng.uniform(lo, hi, (n, 3)).astype(np.float32)
        point_radiance = lrng.uniform(0.05, 0.5, (n, 3)).astype(np.float32)
        point_radius = np.full(n, np.linalg.norm(hi - lo), np.float32)
    else:  # one light above the grid
        point_position = (center + np.array([0.0, 0.75 * ext, 0.0]))[None]
        point_radiance = (np.array([1.0, 0.9, 0.8]) * ext * ext)[None]
        point_radius = np.array([4.0 * ext])
    view = np.array([1.0, 0.7, 1.2])
    eye = center + view / np.linalg.norm(view) * 0.9 * ext
    return {
        "p0": p0, "p1": p1, "p2": p2,
        "aidx": aidx,
        "a_packed": a_packed,
        "tri_material": np.repeat(cluster_mat, pad),
        "cluster_material": cluster_mat,
        "materials": {k: v.copy() for k, v in MATERIALS.items()},
        "sun_irradiance": SUN_IRRADIANCE.copy(),
        "sun_direction": SUN_DIRECTION.copy(),
        "point_position": point_position.astype(np.float32),
        "point_radiance": point_radiance.astype(np.float32),
        "point_radius": point_radius.astype(np.float32),
        "eye": eye.astype(np.float32),
        "target": center.astype(np.float32),
    }


def permuted(inputs: dict, seed: int) -> dict:
    """The same scene with its point lights in an order drawn from
    `seed`: every light keeps its position, radiance and radius, so the
    work of a frame stays the same while the lights that each pixel's
    random picks land on change. The plates keep their order: a scene's
    clusters lie in memory in spatial order, as meshlets do."""
    order = np.random.default_rng(seed).permutation(
        inputs["point_position"].shape[0])
    out = dict(inputs)
    for k in ("point_position", "point_radiance", "point_radius"):
        out[k] = inputs[k][order]
    return out


def make(config: dict, seed: int) -> dict:
    """The inputs of a configuration file whose generator is "plate": the
    scene of the configuration's `layout_seed` (its plates and lights),
    its lights in the order that the run's seed draws."""
    base = make_plate_inputs(int(config["n_clusters"]),
                             int(config["layout_seed"]),
                             int(config["scatter_lights"]),
                             light_seed=int(config["layout_seed"]))
    return permuted(base, int(seed))
