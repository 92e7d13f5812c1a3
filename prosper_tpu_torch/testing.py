"""Procedural scenes as numpy dicts, and as glTF files.

Counterpart of prosper_tpu/testing.py. Both scene functions return
(static, frame, arena, cam_fn) in the layout of
`prosper_tpu.testing.make_test_scene`, so either package can consume
them: `static` holds the object-space triangle arena and materials,
`frame` the per-frame AABBs, BVH2 node arrays and light uniforms,
`arena` a 1-px white texture arena (plus an alpha checker where a plate
scene has alpha-masked plates), and `cam_fn(w, h)` camera uniforms.

`make_tie_scene` builds exact t ties for the closest-hit walks: one
triangle copied into several lanes of two clusters under a two-leaf
BVH2, with rays that visit either cluster first.

`write_gltf` writes a glTF 2.0 file (.gltf with a .bin buffer, or .glb)
from a document whose accessors and images are numpy arrays;
`write_plate_gltf` writes the plate scene's triangles, lights and camera
as such a file, for the scene path (scene/world.py).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np

from .accel.bvh import build_bvh, pack_nodes
from .mathx.transforms import look_at
from .scene.camera import Camera, CameraParameters, CameraTransform
from .scene.lights import MAX_POINT_LIGHTS, LightArrays, light_uniforms
from .scene.textures import pack_rgba8_quads

CLUSTER_TRI_PAD = 128  # triangles per cluster slab (scene/meshlets.py)


def _white_arena() -> dict:
    """1 px white default texture arena (quad layout)."""
    return {
        "data": np.full((1, 4), 0xFFFFFFFF, np.uint32),
        "table": np.zeros((1, 13, 4), np.int32)
        + np.array([0, 1, 1, 0], np.int32)[None, None, :],
        "n_mips": np.ones(1, np.int32),
    }


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
        "data": np.concatenate([arena["data"], pack_rgba8_quads(img)]),
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


def _unit_plate(g: int = 8):
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


def _plate_frames(n_clusters: int, rng):
    """Each plate's origin (f64) and random rotation (f32, from QR, so
    it may be a reflection): a cell of a side^3 grid of 1.5 spacing,
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

    S = n_clusters * pad
    p0 = np.zeros((S, 3), np.float32)
    p1 = np.zeros((S, 3), np.float32)
    p2 = np.zeros((S, 3), np.float32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)
    a_packed = np.zeros((n_clusters * nv, 12), np.float32)

    verts, tris_local = _unit_plate(g)
    for ci, (origin, rot) in enumerate(zip(*_plate_frames(n_clusters, rng))):
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


# The tie scene's copies of one triangle, by cluster. Cluster 0's lowest
# copy sits in warp lane 9 and its others in lane 4; cluster 1's lowest
# in lane 8, its last in lane 7: a minimum over lanes, not over triangle
# indices, would pick another copy.
TIE_LANES = ((9, 36, 68, 100), (40, 72, 103))


def make_tie_scene(n_rays: int = 64, seed: int = 0, rows: int = 9):
    """Exact t ties for the closest-hit walks: one triangle in the plane
    z = 5, copied into the lanes TIE_LANES[c] of clusters 0 and 1 (every
    other lane degenerate, zero edges), under a BVH2 root whose leaves
    are cluster 0's box (z in [2, 8]) and cluster 1's (z in [1, 6]).

    Even rays go up (+z) from z = 0 and enter cluster 1's box first, odd
    rays down from z = 10 and enter cluster 0's first; each ray's x, y
    is uniform in [-2, 2]. Every ray meets every copy at the same t, so
    a walk that keeps a strict t < best over ascending lanes returns the
    lowest copy of the cluster it visits first: tri 128 + 40 for the up
    rays, 9 for the down rays (a brute-force minimum of (t, tri) gives 9
    to all).

    rows > 9 (38 or more for the attribute kernels) adds slab rows 9 up
    to rows of uniform values in [-1, 1) from `seed`, a distinct
    attribute row for every lane, so a full hit row shows which copy a
    walk kept.

    Returns numpy (slabs (2, rows, 128) f32, bounds (3, 6) f32, meta
    (3, 3) i32, o (R, 3) f32, d (R, 3) f32, the walk's tri per ray (R,)
    i64)."""
    slabs = np.zeros((2, rows, CLUSTER_TRI_PAD), np.float32)
    tri = np.array([-10.0, -10.0, 5.0, 30.0, 0.0, 0.0, 0.0, 30.0, 0.0],
                   np.float32)  # v0 | e1 | e2
    for c, lanes in enumerate(TIE_LANES):
        slabs[c][0:9, list(lanes)] = tri[:, None]
    bounds = np.array([[-10, -10, 1, 20, 20, 8],
                       [-10, -10, 2, 20, 20, 8],
                       [-10, -10, 1, 20, 20, 6]], np.float32)
    meta = np.array([[1, 2, -1], [-1, -1, 0], [-1, -1, 1]], np.int32)
    rng = np.random.default_rng(seed)
    up = np.arange(n_rays) % 2 == 0
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0:2] = rng.uniform(-2.0, 2.0, (n_rays, 2))
    o[:, 2] = np.where(up, 0.0, 10.0)
    d = np.zeros((n_rays, 3), np.float32)
    d[:, 2] = np.where(up, 1.0, -1.0)
    slabs[:, 9:] = rng.uniform(-1.0, 1.0, (2, rows - 9, CLUSTER_TRI_PAD))
    want = np.where(up, CLUSTER_TRI_PAD + TIE_LANES[1][0], TIE_LANES[0][0])
    return slabs, bounds, meta, o, d, want.astype(np.int64)


# ---------------------------------------------------------------------------
# glTF files

_COMPONENT_TYPES = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125,
                    np.dtype(np.uint16): 5123, np.dtype(np.uint8): 5121}
_ACCESSOR_TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4"}


def _png_bytes(pixels: np.ndarray) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(np.asarray(pixels, np.uint8)).save(out, format="PNG")
    return out.getvalue()


def write_gltf(path, doc: dict) -> str:
    """Write a glTF 2.0 document and return its path.

    `doc` is glTF JSON except that primitive attributes and indices and
    animation sampler inputs and outputs are numpy arrays (float32,
    uint32, uint16 or uint8; (N,) or (N, 1-4)), which become accessors
    of one buffer, and each image is {"pixels": (H, W, 3|4) uint8} plus
    either "uri" (a PNG file written next to the document) or nothing
    (the PNG embedded in the buffer). A path ending in .glb writes a
    binary glTF, else a .gltf with its buffer in a .bin beside it."""
    path = os.fspath(path)
    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    blob = bytearray()
    views: list[dict] = []
    accessors: list[dict] = []

    def view(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(a) -> int:
        a = np.ascontiguousarray(a)
        n = 1 if a.ndim == 1 else a.shape[1]
        acc = {"bufferView": view(a.tobytes()),
               "componentType": _COMPONENT_TYPES[a.dtype],
               "count": int(a.shape[0]), "type": _ACCESSOR_TYPES[n]}
        if a.dtype == np.float32 and n == 3:
            acc["min"] = a.min(0).tolist()
            acc["max"] = a.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    out = {k: v for k, v in doc.items()}
    out.setdefault("asset", {"version": "2.0"})
    out["meshes"] = [
        {**m, "primitives": [
            {**p, "attributes": {k: accessor(v)
                                 for k, v in p["attributes"].items()},
             **({"indices": accessor(p["indices"])} if "indices" in p else {})}
            for p in m["primitives"]]}
        for m in doc.get("meshes", [])]
    if "animations" in doc:
        out["animations"] = [
            {**a, "samplers": [
                {**s, "input": accessor(s["input"]),
                 "output": accessor(s["output"])} for s in a["samplers"]]}
            for a in doc["animations"]]
    images = []
    for img in doc.get("images", []):
        if "uri" in img:
            img_path = os.path.join(base, img["uri"])
            with open(img_path, "wb") as f:
                f.write(_png_bytes(img["pixels"]))
            images.append({"uri": img["uri"]})
        else:
            images.append({"bufferView": view(_png_bytes(img["pixels"])),
                           "mimeType": "image/png"})
    if images:
        out["images"] = images
    blob.extend(b"\0" * (-len(blob) % 4))
    out["accessors"], out["bufferViews"] = accessors, views
    out["buffers"] = [{"byteLength": len(blob)}]
    if path.endswith(".glb"):
        js = json.dumps(out).encode()
        js += b" " * (-len(js) % 4)
        chunks = (len(js).to_bytes(4, "little") + b"JSON" + js
                  + len(blob).to_bytes(4, "little") + b"BIN\0" + bytes(blob))
        with open(path, "wb") as f:
            f.write(b"glTF" + (2).to_bytes(4, "little")
                    + (12 + len(chunks)).to_bytes(4, "little") + chunks)
        return path
    bin_name = os.path.splitext(os.path.basename(path))[0] + ".bin"
    out["buffers"][0]["uri"] = bin_name
    with open(os.path.join(base, bin_name), "wb") as f:
        f.write(bytes(blob))
    with open(path, "w") as f:
        json.dump(out, f)
    return path


def mat3_to_quat(r: np.ndarray) -> np.ndarray:
    """A rotation matrix -> its unit quaternion (x, y, z, w), glTF order."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * np.sqrt(1.0 + tr)
        q = [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-30))
        q = [0.0] * 4
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        q[3] = (r[k, j] - r[j, k]) / s
    q = np.asarray(q)
    return (q / np.linalg.norm(q)).astype(np.float32)


def _plate_images(seed: int) -> list[dict]:
    """The plate scene's three textures: a 512^2 sRGB base color (colour
    cells under a fine checker), a 256^2 linear metallic-roughness map
    (roughness in G, metallic in B) and a 256^2 linear normal map of
    gentle bumps."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:512, 0:512]
    cells = rng.integers(60, 255, (8, 8, 3))
    base = cells[y // 64, x // 64] * np.where((x // 8 + y // 8) % 2, 1.0,
                                              0.7)[..., None]
    base = np.concatenate([base, np.full((512, 512, 1), 255.0)], -1)
    y, x = np.mgrid[0:256, 0:256] / 256.0
    mr = np.stack([np.zeros_like(x), 0.5 + 0.5 * np.sin(6.283 * 3 * x) ** 2,
                   (y > 0.5).astype(np.float64), np.ones_like(x)], -1) * 255.0
    nx = 0.3 * np.sin(6.283 * 4 * x)
    ny = 0.3 * np.cos(6.283 * 4 * y)
    n = np.stack([nx, ny, np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = np.concatenate([(n * 0.5 + 0.5) * 255.0, np.full((256, 256, 1),
                                                           255.0)], -1)
    return [{"uri": name, "pixels": np.clip(img + 0.5, 0, 255).astype(np.uint8)}
            for name, img in (("base.png", base), ("mr.png", mr),
                              ("normal.png", nrm))]


def write_plate_gltf(directory, n_clusters: int = 2048, seed: int = 0,
                     n_instanced: int = 64, scatter_lights: int = 1024,
                     name: str = "plates.gltf") -> str:
    """make_plate_scene's plates, lights and camera as a glTF file in
    `directory`; returns its path.

    Two meshes: "plates", the first n_clusters - n_instanced plates in
    world space (their 128 triangles each, with normals and uvs, no
    tangents: World generates MikkTSpace ones), and "plate", the unit
    plate, instanced by n_instanced nodes under a parent node with TRS
    transforms that place the remaining plates (a reflected plate takes
    the scale (-1, 1, 1)). The triangles equal make_plate_scene's up to
    float rounding: n_clusters * 128 in all, 262,144 at 2048. World cuts
    them into clusters of at most 124: 1984 static plates fill 2048
    clusters exactly, and each instance adds two.

    Materials: the rough dielectric of the plate scene on "plates", with
    a sRGB base color texture and a linear metallic-roughness texture;
    the metal on "plate", with a normal map; PNG files beside the
    document. Lights: scatter_lights point lights as KHR_lights_punctual
    nodes (make_plate_scene's scatter recipe: radiance U(0.05, 0.5) as
    the colour, intensity 4 pi, range the bounds' diagonal), else its one
    point light; no directional light, so World keeps the default sun.
    A camera node at make_plate_scene's eye, aimed at the grid's
    centre."""
    rng = np.random.default_rng(seed)
    verts, tris = _unit_plate()
    origins, rots = _plate_frames(n_clusters, rng)
    n_static = n_clusters - n_instanced
    nv = len(verts)
    world = [(verts @ rot.T + origin).astype(np.float32)
             for origin, rot in zip(origins, rots)]
    lo = np.min([w.min(0) for w in world], axis=0)
    hi = np.max([w.max(0) for w in world], axis=0)
    uv = np.ascontiguousarray(verts[:, :2])

    plates = {
        "POSITION": np.concatenate(world[:n_static]),
        "NORMAL": np.concatenate([np.tile(rot[:, 2], (nv, 1)).astype(
            np.float32) for rot in rots[:n_static]]),
        "TEXCOORD_0": np.tile(uv, (n_static, 1)),
    }
    plate = {"POSITION": verts,
             "NORMAL": np.tile(np.float32([0, 0, 1]), (nv, 1)),
             "TEXCOORD_0": uv}
    meshes = [
        {"name": "plates", "primitives": [{
            "attributes": plates, "material": 0,
            "indices": (tris[None] + nv * np.arange(n_static)[:, None, None])
            .reshape(-1).astype(np.uint32)}]},
        {"name": "plate", "primitives": [{
            "attributes": plate, "material": 1,
            "indices": tris.reshape(-1).astype(np.uint16)}]},
    ]
    parent_t = np.float32([0.5, 0.0, -0.25])
    nodes = [{"name": "plates", "mesh": 0},
             {"name": "instances", "translation": parent_t.tolist(),
              "children": list(range(2, 2 + n_instanced))}]
    for origin, rot in zip(origins[n_static:], rots[n_static:]):
        scale = [1.0, 1.0, 1.0]
        if np.linalg.det(rot) < 0:
            rot = rot * np.float32([-1.0, 1.0, 1.0])[None, :]
            scale = [-1.0, 1.0, 1.0]
        nodes.append({"mesh": 1,
                      "translation": (origin - parent_t).tolist(),
                      "rotation": mat3_to_quat(rot).tolist(),
                      "scale": scale})

    center = (lo + hi) / 2
    ext = float(np.max(hi - lo))
    if scatter_lights > 0:
        lrng = np.random.default_rng(0)
        n = min(scatter_lights, MAX_POINT_LIGHTS)
        pos = lrng.uniform(lo, hi, (n, 3))
        color = lrng.uniform(0.05, 0.5, (n, 3))
        lights = [{"type": "point", "color": c.tolist(),
                   "intensity": 4.0 * np.pi,
                   "range": float(np.linalg.norm(hi - lo))} for c in color]
    else:
        pos = [center + np.array([0.0, 0.75 * ext, 0.0])]
        lights = [{"type": "point", "color": [1.0, 0.9, 0.8],
                   "intensity": 4.0 * np.pi * ext * ext, "range": 4.0 * ext}]
    for i, p in enumerate(pos):
        nodes.append({"translation": np.asarray(p, np.float32).tolist(),
                      "extensions": {"KHR_lights_punctual": {"light": i}}})

    view = np.array([1.0, 0.7, 1.2])
    eye = center + view / np.linalg.norm(view) * 0.9 * ext
    w2c = look_at(eye, center, np.array([0.0, 1.0, 0.0]))
    nodes.append({"name": "camera", "camera": 0,
                  "translation": np.asarray(eye, np.float32).tolist(),
                  "rotation": mat3_to_quat(w2c[:3, :3].T).tolist()})

    doc = {
        "scene": 0,
        "scenes": [{"nodes": [0, 1] + list(range(2 + n_instanced,
                                                 len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": [
            {"name": "rough dielectric", "pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.8, 0.75, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.6,
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}}},
            {"name": "metal", "pbrMetallicRoughness": {
                "baseColorFactor": [0.95, 0.64, 0.54, 1.0],
                "metallicFactor": 1.0, "roughnessFactor": 0.35},
             "normalTexture": {"index": 2}},
        ],
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
        "textures": [{"source": i, "sampler": 0} for i in range(3)],
        "images": _plate_images(seed),
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": float(np.radians(59.0)), "znear": 0.1, "zfar": 100.0,
            "aspectRatio": 16 / 9}}],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
    }
    return write_gltf(os.path.join(os.fspath(directory), name), doc)
