"""A glTF scene of textured plates, written from a seed: the glTF form
of a generator's inputs.

The plate recipe of `plate.py` (plates randomly rotated in a 3D grid of
1.5 spacing), with plates of 7x7 quads, written as a glTF 2.0 file that
the program loads through its own glTF path:

- meshes 0 .. n_static - 1, "plate<k>": the first n_static =
  n_clusters - n_instanced plates, a mesh each, in world space (each
  under a node of its own with the identity transform), with normals,
  tangents and uvs (twice over the plate, so the REPEAT wrap is
  sampled), material 0: a base colour texture (sRGB) and a
  metallic-roughness texture (linear, roughness in G, metallic in B);
- mesh n_static, "plate": the unit plate, instanced by n_instanced
  nodes under a parent node with TRS transforms that place the
  remaining plates; every third of them (the second, the fifth, ...) is
  reflected, by the scale (-1, 1, 1). Material 1: a metal with a normal
  map (linear);
- scatter_lights point lights (KHR_lights_punctual) scattered in the
  scene bounds, each with a range of light_range times the bounds'
  diagonal, so that a light reaches only part of the scene; no
  directional light, so the renderer's default sun shines;
- PNG images beside the document, REPEAT samplers.

Triangles wind counter-clockwise about their vertex normals, as glTF's
front faces do. Positions and uvs are rounded to float16 before they are written, so the
renderer's float16 vertex packing leaves them as they are. The file goes
into a fresh directory (`tempfile.mkdtemp`, under TMPDIR), returned as
"scene_dir" for the harness to remove once the scene is built.

A plate of 7x7 quads (64 vertices, 98 triangles) is one cluster of the
port's World within upstream's meshlet limits; World cuts the plate
recipe's 8x8 quads (81 vertices) into clusters of 124 and 4 triangles,
the first beyond upstream's 64 vertices, which the reference refuses.

`make` returns the glTF form: "gltf" (the file's path), "scene_dir", and
the arrays the file was written from, which the plain reference reads:
"meshes" (positions, normals, tangents, uv, indices, material), "nodes"
(mesh, translation, rotation, scale, children), "roots", "materials"
(factors and image indices, -1 for none), "images" (pixels, srgb),
the sun, the point lights, and the camera's eye and target.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib

import numpy as np

from .plate import MAX_POINT_LIGHTS, SUN_DIRECTION, SUN_IRRADIANCE, plate_frames, unit_plate

PLATE_QUADS = 7  # quads a side of a plate (see the module docstring)
UV_REPEAT = 2.0  # uv spans [0, 2] over a plate: the texture wraps once
REPEAT = 10497  # the glTF sampler wrap mode


def f16(a) -> np.ndarray:
    """float32 values that float16 holds exactly."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def mat3_to_quat(r) -> np.ndarray:
    """A rotation matrix -> its unit quaternion (x, y, z, w)."""
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


def png_bytes(pixels: np.ndarray) -> bytes:
    """(H, W, 4) uint8 -> an RGBA PNG (filter 0 on every row)."""
    h, w = pixels.shape[:2]
    raw = b"".join(b"\0" + pixels[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def images(rng, base: int, mr: int, normal: int) -> list[dict]:
    """The three textures: a base colour of colour cells under a fine
    checker (sRGB), a metallic-roughness map (roughness in G, metallic in
    B) and a normal map of gentle bumps (both linear)."""
    y, x = np.mgrid[0:base, 0:base]
    cells = rng.integers(60, 255, (8, 8, 3))
    cell = max(base // 8, 1)
    check = max(base // 64, 1)
    bc = cells[(y // cell) % 8, (x // cell) % 8] * np.where(
        (x // check + y // check) % 2, 1.0, 0.7)[..., None]
    bc = np.concatenate([bc, np.full((base, base, 1), 255.0)], -1)
    y, x = np.mgrid[0:mr, 0:mr] / float(mr)
    mrm = np.stack([np.zeros_like(x), 0.3 + 0.6 * np.sin(6.283 * 3 * x) ** 2,
                    (y > 0.5).astype(np.float64), np.ones_like(x)], -1) * 255.0
    y, x = np.mgrid[0:normal, 0:normal] / float(normal)
    n = np.stack([0.3 * np.sin(6.283 * 4 * x), 0.3 * np.cos(6.283 * 4 * y),
                  np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nm = np.concatenate([(n * 0.5 + 0.5) * 255.0,
                         np.full((normal, normal, 1), 255.0)], -1)
    return [{"pixels": np.clip(img + 0.5, 0, 255).astype(np.uint8),
             "srgb": srgb, "wrap": (REPEAT, REPEAT)}
            for img, srgb in ((bc, True), (mrm, False), (nm, False))]


def write_gltf(directory: str, doc: dict, meshes: list[dict],
               imgs: list[dict]) -> str:
    """The document with the meshes' arrays as accessors of one buffer
    (scene.bin) and the images as PNG files beside it; returns the
    path of scene.gltf."""
    blob = bytearray()
    views, accessors = [], []

    def accessor(a, ctype: int, kind: str) -> int:
        data = np.ascontiguousarray(a).tobytes()
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(data)})
        blob.extend(data)
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "count": int(len(a)), "type": kind}
        if kind == "VEC3" and ctype == 5126:
            acc["min"] = np.asarray(a).min(0).tolist()
            acc["max"] = np.asarray(a).max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    doc = dict(doc)
    doc["meshes"] = [{"name": m["name"], "primitives": [{
        "attributes": {
            "POSITION": accessor(m["positions"].astype(np.float32), 5126, "VEC3"),
            "NORMAL": accessor(m["normals"].astype(np.float32), 5126, "VEC3"),
            "TANGENT": accessor(m["tangents"].astype(np.float32), 5126, "VEC4"),
            "TEXCOORD_0": accessor(m["uv"].astype(np.float32), 5126, "VEC2")},
        "indices": accessor(m["indices"].reshape(-1).astype(np.uint32), 5125,
                            "SCALAR"),
        "material": int(m["material"])}]} for m in meshes]
    doc["images"] = []
    for i, img in enumerate(imgs):
        name = f"image{i}.png"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(png_bytes(img["pixels"]))
        doc["images"].append({"uri": name})
    doc["samplers"] = [{"wrapS": REPEAT, "wrapT": REPEAT}]
    doc["textures"] = [{"source": i, "sampler": 0} for i in range(len(imgs))]
    blob.extend(b"\0" * (-len(blob) % 4))
    with open(os.path.join(directory, "scene.bin"), "wb") as f:
        f.write(bytes(blob))
    doc.update(asset={"version": "2.0"}, accessors=accessors,
               bufferViews=views,
               buffers=[{"uri": "scene.bin", "byteLength": len(blob)}])
    path = os.path.join(directory, "scene.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def make_inputs(n_clusters: int, n_instanced: int, scatter_lights: int,
                light_range: float, layout_seed: int, texture_sizes,
                seed: int) -> dict:
    """The arrays of the scene of `layout_seed`, its lights in the order
    that `seed` draws, written as a glTF file (see the module
    docstring)."""
    rng = np.random.default_rng(layout_seed)
    verts, tris = unit_plate(PLATE_QUADS)
    tris = tris[:, [0, 2, 1]]  # counter-clockwise about the normal (+z)
    origins, rots = plate_frames(n_clusters, rng)
    n_static = n_clusters - n_instanced
    nv = len(verts)
    world = [f16(verts @ rot.T + origin) for origin, rot in zip(origins, rots)]
    lo = np.min([w.min(0) for w in world], axis=0)
    hi = np.max([w.max(0) for w in world], axis=0)
    uv = f16(verts[:, :2] * UV_REPEAT)

    meshes = [{"name": f"plate{k}", "material": 0, "positions": world[k],
               "normals": np.tile(rots[k][:, 2], (nv, 1)).astype(np.float32),
               "tangents": np.tile(np.append(rots[k][:, 0], np.sign(
                   np.linalg.det(rots[k]))), (nv, 1)).astype(np.float32),
               "uv": uv, "indices": tris.astype(np.int64)}
              for k in range(n_static)]
    meshes.append({"name": "plate", "material": 1, "positions": f16(verts),
                   "normals": np.tile(np.float32([0, 0, 1]), (nv, 1)),
                   "tangents": np.tile(np.float32([1, 0, 0, 1]), (nv, 1)),
                   "uv": uv, "indices": tris.astype(np.int64)})

    def node(mesh, translation, rotation=(0, 0, 0, 1), scale=(1, 1, 1),
             children=()):
        return {"mesh": mesh, "translation": np.float32(translation),
                "rotation": np.float32(rotation), "scale": np.float32(scale),
                "children": list(children)}

    parent_t = np.float32([0.5, 0.0, -0.25])
    nodes = [node(k, (0, 0, 0)) for k in range(n_static)]
    nodes.append(node(None, parent_t, children=range(
        n_static + 1, n_static + 1 + n_instanced)))
    for k, (origin, rot) in enumerate(zip(origins[n_static:], rots[n_static:])):
        nodes.append(node(n_static, origin - parent_t, mat3_to_quat(rot),
                          (-1.0 if k % 3 == 1 else 1.0, 1.0, 1.0)))
    roots = list(range(n_static + 1))

    # the lights of the layout, in the order the run's seed draws
    lrng = np.random.default_rng(layout_seed)
    n = min(scatter_lights, MAX_POINT_LIGHTS)
    pos = lrng.uniform(lo, hi, (n, 3)).astype(np.float32)
    radiance = lrng.uniform(0.05, 0.5, (n, 3)).astype(np.float32)
    radius = np.full(n, light_range * np.linalg.norm(hi - lo), np.float32)
    order = np.random.default_rng(seed).permutation(n)
    pos, radiance, radius = pos[order], radiance[order], radius[order]
    light_nodes = [{"translation": p.tolist(),
                    "extensions": {"KHR_lights_punctual": {"light": i}}}
                   for i, p in enumerate(pos)]
    lights = [{"type": "point", "color": c.tolist(), "intensity": 4.0 * np.pi,
               "range": float(r)} for c, r in zip(radiance, radius)]

    imgs = images(rng, *texture_sizes)
    materials = {
        "base_color_factor": np.float32([[0.8, 0.8, 0.75, 1.0],
                                         [0.95, 0.64, 0.54, 1.0]]),
        "metallic_factor": np.float32([0.0, 1.0]),
        "roughness_factor": np.float32([0.6, 0.35]),
        "alpha_cutoff": np.float32([0.5, 0.5]),
        "alpha_mode": np.int32([0, 0]),
        "base_color_tex": np.int32([0, -1]),
        "metallic_roughness_tex": np.int32([1, -1]),
        "normal_tex": np.int32([-1, 2]),
    }
    doc = {
        "scene": 0,
        "scenes": [{"nodes": roots + list(range(len(nodes),
                                                len(nodes) + n))}],
        "nodes": [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in nd.items() if k != "mesh" or v is not None}
                  for nd in nodes] + light_nodes,
        "materials": [
            {"name": "rough dielectric", "pbrMetallicRoughness": {
                "baseColorFactor": materials["base_color_factor"][0].tolist(),
                "metallicFactor": 0.0, "roughnessFactor": 0.6,
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}}},
            {"name": "metal", "pbrMetallicRoughness": {
                "baseColorFactor": materials["base_color_factor"][1].tolist(),
                "metallicFactor": 1.0, "roughnessFactor": 0.35},
             "normalTexture": {"index": 2}},
        ],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
    }
    for nd in doc["nodes"]:
        if not nd.get("children", True):
            del nd["children"]
    directory = tempfile.mkdtemp(prefix="frame_bench_scene_")
    path = write_gltf(directory, doc, meshes, imgs)

    center = (lo + hi) / 2
    ext = float(np.max(hi - lo))
    view = np.array([1.0, 0.7, 1.2])
    eye = center + view / np.linalg.norm(view) * 0.9 * ext
    return {
        "gltf": path, "scene_dir": directory,
        "meshes": meshes, "nodes": nodes, "roots": roots,
        "materials": materials, "images": imgs,
        "sun_irradiance": SUN_IRRADIANCE.copy(),
        "sun_direction": SUN_DIRECTION.copy(),
        "point_position": pos, "point_radiance": radiance,
        "point_radius": radius,
        "eye": eye.astype(np.float32), "target": center.astype(np.float32),
    }


def make(config: dict, seed: int) -> dict:
    """The inputs of a configuration file whose generator is
    "gltf_plates": the scene of its `layout_seed`, its lights in the
    order that the run's seed draws."""
    return make_inputs(int(config["n_clusters"]), int(config["n_instanced"]),
                       int(config["scatter_lights"]),
                       float(config["light_range"]),
                       int(config["layout_seed"]),
                       [int(s) for s in config["texture_sizes"]], int(seed))
