"""A Sponza-class atrium written from a seed as a glTF file: the glTF form
of a generator's inputs, as `gltf_plates.py` gives it.

A courtyard (24 x 14 m, y up) with two storeys of colonnades on its long
sides, open to the sky, authored as a level is: 16 meshes of their own
kinds, each with its own material, placed by nodes:

- sheets (grids over a surface) with uv seams: the texture restarts
  every few quads, the vertices of a seam being written twice, as at a
  material border: the floor (the courtyard and the ground galleries,
  which takes whatever of the triangle budget the rest leaves, its last
  row of quads partial), the long walls of each storey, the end walls,
  the galleries' ceilings and floors between the storeys;
- a lathed column (base, shaft with entasis, capital; four uv tiles
  about it), instanced by 32 nodes under a parent node, every third of
  them reflected by the scale (-1, 1, 1); a lathed plinth under each;
  a lathed vase, instanced 8 times;
- arches swept from a rectangular profile along a half circle between
  each pair of columns (28 nodes); a frieze, a parapet and a cornice
  swept along each colonnade;
- three dense hanging banners, each a fine grid with folds, hung from
  the upper gallery (8 nodes).

Every mesh has 0.55 vertices or more a triangle (its seams), so a
partition into 124-triangle ranges breaks upstream's 64-vertex meshlet
limit on most clusters. Triangles wind counter-clockwise about their
vertex normals. No two faces lie in one plane where they overlap
(neighbouring arches meet at a column's axis, the parapet passes through
the gallery floor), so that no pixel's closest hit is a tie that
rounding decides. Positions and uvs are rounded to float16 before they are
written, as `gltf_plates.py` rounds them.

The world triangle count, each instance counted, is `triangles` exactly:
the other meshes are sized from it (by the square root of its share of
262,144) and the floor takes the rest. Each of the 16 materials has a
base colour (sRGB), a metallic-roughness map (roughness in G, metallic
in B) and a normal map, `texture_size` square, drawn from `layout_seed`
and written as PNG files at zlib level 1. `scatter_lights` point lights
(KHR_lights_punctual) lie in the atrium's bounds, each with a range of
`light_range` times the bounds' diagonal; no directional light, so the
renderer's default sun shines. The camera's eye and target are inside
the courtyard: from every position of an orbit about the target the
columns hide part of the galleries and walls behind them.

`make` returns the glTF form, as `gltf_plates.make` does.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib

import numpy as np

from .gltf_plates import REPEAT, f16, mat3_to_quat, write_gltf
from .plate import MAX_POINT_LIGHTS, SUN_DIRECTION, SUN_IRRADIANCE

HALF_X, HALF_Z = 12.0, 7.0  # the atrium's floor, walls at its edges
COLONNADE_Z = 5.0  # the columns' line on each long side
STOREY = 5.0  # two storeys
COLUMN_X = (-10.5, -7.5, -4.5, -1.5, 1.5, 4.5, 7.5, 10.5)
COLUMN_HEIGHT = 3.2  # the arches spring from the columns' tops
FULL_BUDGET = 262144  # the triangles the base resolutions below are set for
EYE = np.float32([3.5, 1.0, 0.0])  # from TARGET: an orbit of radius 3.5 m
TARGET = np.float32([0.0, 3.0, 0.0])


def _res(n: int, detail: float, least: int) -> int:
    return max(least, int(round(n * detail)))


def sheet(surface, nu: int, nv: int, seam: int, closed: bool = False,
          flip: bool = False, uv_v: float = 1.0, n_quads: int | None = None
          ) -> dict:
    """A grid of nu x nv quads over surface(u, v) -> (..., 3) positions
    (u, v in [0, 1]). The uv's u restarts every `seam` quads (0 to 1 over
    a tile), the vertices of a seam written twice; v runs 0 to uv_v.
    closed: u wraps (the last vertex column lies on the first). Normals
    face du x dv (-(du x dv) with flip); n_quads keeps only the first
    quads, row by row. Returns the mesh arrays without a material."""
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    p = surface(u[:, None], v[None, :]).astype(np.float64)  # (nu+1, nv+1, 3)
    if closed:
        dpu = np.roll(p[:-1], -1, 0) - np.roll(p[:-1], 1, 0)
        dpu = np.concatenate([dpu, dpu[:1]], 0)
    else:
        dpu = np.gradient(p, axis=0)
    dpv = np.gradient(p, axis=1)
    n = np.cross(dpu, dpv) * (-1.0 if flip else 1.0)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    t = dpu / np.maximum(np.linalg.norm(dpu, axis=-1, keepdims=True), 1e-20)
    w = np.where(np.sum(np.cross(n, t) * dpv, -1) >= 0, 1.0, -1.0)

    # vertex columns: column i, and at a seam a second copy starting a tile
    left, right, cols = [], [], []  # quad i's vertex columns; (i, uv u)
    for i in range(nu + 1):
        if i > 0:
            right.append(len(cols))
            cols.append((i, (i - 1) % seam / seam + 1.0 / seam))
        if i < nu and (i == 0 or i % seam == 0):
            left.append(len(cols))
            cols.append((i, 0.0))
        elif i < nu:
            left.append(right[-1])
    src = np.array([c for c, _ in cols])
    uu = np.array([x for _, x in cols])
    nc = len(cols)
    vid = np.arange(nc * (nv + 1)).reshape(nc, nv + 1)
    qi, qj = np.meshgrid(np.arange(nu), np.arange(nv), indexing="xy")
    qi, qj = qi.ravel(), qj.ravel()  # row by row
    if n_quads is not None:
        qi, qj = qi[:n_quads], qj[:n_quads]
    a = vid[np.array(left)[qi], qj]
    b = vid[np.array(right)[qi], qj]
    c = vid[np.array(left)[qi], qj + 1]
    d = vid[np.array(right)[qi], qj + 1]
    first, second = (np.stack([a, b, c], 1), np.stack([b, d, c], 1))
    if flip:
        first, second = first[:, [0, 2, 1]], second[:, [0, 2, 1]]
    tris = np.stack([first, second], 1).reshape(-1, 3)
    used, tris = np.unique(tris, return_inverse=True)
    tris = tris.reshape(-1, 3)
    col, row = used // (nv + 1), used % (nv + 1)
    return {
        "positions": f16(p[src[col], row]),
        "normals": n[src[col], row].astype(np.float32),
        "tangents": np.concatenate([t[src[col], row], w[src[col], row, None]],
                                   -1).astype(np.float32),
        "uv": f16(np.stack([uu[col], v[row] * uv_v], -1)),
        "indices": tris.astype(np.int64),
    }


def plane(origin, du, dv):
    """surface(u, v) = origin + u du + v dv; faces du x dv."""
    o, du, dv = (np.asarray(x, np.float64) for x in (origin, du, dv))
    return lambda u, v: o + u[..., None] * du + v[..., None] * dv


def lathe(radius, height):
    """A surface of revolution about +y: radius(v), height(v); with
    flip=True in `sheet` it faces outward."""
    def surface(u, v):
        a = 2.0 * np.pi * u
        r = radius(v)
        return np.stack(np.broadcast_arrays(r * np.cos(a), height(v) + 0 * a,
                                            r * np.sin(a)), -1)
    return surface


def loop_profile(points):
    """u in [0, 1] along a closed polyline of 2D points, by arc length:
    returns f(u) -> (..., 2)."""
    pts = np.asarray(points + points[:1], np.float64)
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0),
                                                        axis=1))])
    s /= s[-1]
    return lambda u: np.stack([np.interp(u, s, pts[:, 0]),
                               np.interp(u, s, pts[:, 1])], -1)


def swept(profile, path):
    """profile(u) -> (..., 2) in a path frame; path(v) -> (origin, e1, e2)
    with e1, e2 (..., 3): position origin + s e1 + t e2."""
    def surface(u, v):
        st = profile(u)
        o, e1, e2 = path(v)
        return o + st[..., 0:1] * e1 + st[..., 1:2] * e2
    return surface


def rectangle(w: float, h: float):
    """The corners of a w x h rectangle about (0, 0) in (s, t)."""
    return [(-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2)]


def straight(x0: float, x1: float):
    """A path along x (e1 = +y, e2 = +z)."""
    def path(v):
        o = np.stack(np.broadcast_arrays(x0 + (x1 - x0) * v, 0 * v, 0 * v), -1)
        return (o, np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]))
    return path


def meshes_of(detail: float, floor_tris: int | None) -> dict:
    """The 16 meshes (without materials) at `detail`, by name; the floor
    of floor_tris triangles (None: no floor)."""
    d = detail
    seg = _res(4, d, 1)  # quads a side of a rectangular profile
    edge = _res(2, d, 1)  # quads an edge of the other profiles
    out = {}
    # walls: north ones at z = -HALF_Z facing +z (a node turns the south)
    out["wall_lower"] = sheet(plane((-HALF_X, 0, -HALF_Z), (2 * HALF_X, 0, 0),
                                    (0, STOREY, 0)),
                              _res(96, d, 12), _res(20, d, 3), 6, uv_v=2.0)
    out["wall_upper"] = sheet(plane((-HALF_X, STOREY, -HALF_Z),
                                    (2 * HALF_X, 0, 0), (0, STOREY, 0)),
                              _res(96, d, 12), _res(20, d, 3), 6, uv_v=2.0)
    out["wall_end"] = sheet(plane((-HALF_X, 0, HALF_Z), (0, 0, -2 * HALF_Z),
                                  (0, 2 * STOREY, 0)),
                            _res(56, d, 8), _res(40, d, 4), 7, uv_v=4.0)
    gallery = HALF_Z - COLONNADE_Z
    out["ceiling"] = sheet(plane((-HALF_X, STOREY - 0.2, -HALF_Z),
                                 (2 * HALF_X, 0, 0), (0, 0, gallery)),
                           _res(96, d, 12), _res(8, d, 2), 6)
    out["gallery_floor"] = sheet(plane((-HALF_X, STOREY, -HALF_Z),
                                       (0, 0, gallery), (2 * HALF_X, 0, 0)),
                                 _res(8, d, 2), _res(96, d, 12), 4, uv_v=6.0)
    # a column: base torus, shaft with entasis, capital
    def col_r(v):
        return (0.25 + 0.08 * np.exp(-((v - 0.03) / 0.03) ** 2)
                - 0.03 * (v - 0.4) ** 2 + 0.12 * np.clip((v - 0.88) / 0.12, 0, 1) ** 2)
    out["column"] = sheet(lathe(col_r, lambda v: COLUMN_HEIGHT * v),
                          _res(48, d, 8), _res(24, d, 4), _res(12, d, 2),
                          closed=True, flip=True, uv_v=3.0)
    out["plinth"] = sheet(lathe(lambda v: 0.45 + 0 * v, lambda v: 0.3 * v),
                          4, _res(6, d, 1), 1, closed=True, flip=True)
    out["vase"] = sheet(lathe(lambda v: 0.18 + 0.2 * np.sin(np.pi * v * 0.9) ** 2,
                              lambda v: 1.1 * v),
                        _res(32, d, 6), _res(20, d, 3), _res(8, d, 2),
                        closed=True, flip=True)
    # an arch: a rectangle (depth 0.5 m, 0.2 m thick) swept over a half
    # circle in the xy plane, springing at y = 0; its outer radius, 1.5 m,
    # half the columns' spacing, so that neighbouring arches meet at a
    # column's axis and do not overlap
    def arch_path(v):
        a = np.pi * v
        r = np.stack(np.broadcast_arrays(np.cos(a), np.sin(a), 0 * a), -1)
        return (1.4 * r, r, np.array([0.0, 0.0, 1.0]))
    out["arch"] = sheet(swept(loop_profile(rectangle(0.2, 0.5)), arch_path),
                        4 * seg, _res(36, d, 6), seg, closed=True, uv_v=4.0)
    # frieze, parapet, cornice: profiles swept along a colonnade (x)
    out["frieze"] = sheet(swept(loop_profile(
        [(-0.2, -0.15), (0.2, -0.15), (0.25, 0.0), (0.2, 0.15), (-0.2, 0.15)]),
        straight(-HALF_X, HALF_X)), 5 * edge, _res(96, d, 12), edge,
        closed=True, flip=True, uv_v=12.0)
    out["parapet"] = sheet(swept(loop_profile(rectangle(1.0, 0.16)),
                                 straight(-HALF_X, HALF_X)),
                           4 * seg, _res(96, d, 12), seg, closed=True,
                           flip=True, uv_v=12.0)
    out["cornice"] = sheet(swept(loop_profile(
        [(-0.15, -0.3), (0.15, -0.3), (0.3, 0.1), (0.15, 0.3), (-0.15, 0.3)]),
        straight(-HALF_X, HALF_X)), 5 * edge, _res(96, d, 12), edge,
        closed=True, flip=True, uv_v=12.0)
    # banners: 1.2 m wide, hanging 3 m, folds of their own
    for name, folds, amp in (("banner_a", 3, 0.05), ("banner_b", 5, 0.035),
                             ("banner_c", 2, 0.08)):
        def banner(u, v, folds=folds, amp=amp):
            x = 1.2 * (u - 0.5) + 0 * v
            return np.stack(np.broadcast_arrays(
                x, -3.0 * (1.0 - v), amp * np.sin(2 * np.pi * folds * u)
                * (0.4 + 0.6 * (1.0 - v))), -1)
        out[name] = sheet(banner, _res(24, d, 4), _res(60, d, 6), 6, uv_v=2.0)
    if floor_tris is None:
        return out
    # the floor: what the budget leaves, facing up, in rows of nu quads
    # across the atrium (z), the last row partial
    nu, quads = _res(148, d, 12), floor_tris // 2
    if quads < 1 or floor_tris % 2:
        raise ValueError(f"the budget leaves the floor {floor_tris} triangles")
    out["floor"] = sheet(plane((-HALF_X, 0, -HALF_Z), (0, 0, 2 * HALF_Z),
                               (2 * HALF_X, 0, 0)), nu, -(-quads // nu), 6,
                         uv_v=20.0, n_quads=quads)
    return out


MESH_ORDER = ("floor", "wall_lower", "wall_upper", "wall_end", "ceiling",
              "gallery_floor", "column", "plinth", "vase", "arch", "frieze",
              "parapet", "cornice", "banner_a", "banner_b", "banner_c")
TURN = mat3_to_quat(np.diag([-1.0, 1.0, -1.0]))  # 180 degrees about y


def placements() -> list[tuple[str, tuple, tuple, tuple]]:
    """(mesh, translation, rotation, scale) of each node but the columns
    (see `make_inputs`), north side first and the south one turned."""
    ident = (0.0, 0.0, 0.0, 1.0)
    one = (1.0, 1.0, 1.0)
    out = [("floor", (0, 0, 0), ident, one)]
    for name in ("wall_lower", "wall_upper", "wall_end", "ceiling",
                 "gallery_floor"):
        out += [(name, (0, 0, 0), ident, one),
                (name, (0, 0, 0), tuple(TURN), one)]
    for side, rot in ((-1, ident), (1, tuple(TURN))):
        z = side * COLONNADE_Z
        for storey in range(2):
            y = storey * STOREY
            for x in COLUMN_X:
                out.append(("plinth", (x, y, z), rot, one))
            for k in range(len(COLUMN_X) - 1):
                x = 0.5 * (COLUMN_X[k] + COLUMN_X[k + 1])
                out.append(("arch", (x, y + COLUMN_HEIGHT, z), rot, one))
        out.append(("frieze", (0, STOREY - 0.35, z), rot, one))
        # through the gallery floor, so that no face lies in its plane
        out.append(("parapet", (0, STOREY + 0.45, z), rot, one))
        out.append(("cornice", (0, 2 * STOREY - 0.1, z), rot, one))
        for k, x in enumerate((-9.0, -3.0, 3.0, 9.0)):
            banner = ("banner_a", "banner_b", "banner_c", "banner_a")[
                (k + (side > 0)) % 4]
            out.append((banner, (x * -side, 2 * STOREY - 0.7, z + 0.5 * -side),
                        rot, one))
            out.append(("vase", (x * -side, 0.0, z + 0.8 * -side), rot, one))
    return out


def rgba(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) values in [0, 1] -> (H, W, 4) RGBA8, alpha 255."""
    out = np.empty(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(img * 255.0 + 0.5, 0, 255)
    out[..., 3] = 255
    return out


def patterns(size: int) -> tuple[list, list, np.ndarray]:
    """The height patterns of the textures at `size` (tiles, bricks,
    stripes, veins), the normal map (RGBA8) of each, and each texel's
    cell of an 8 x 8 grid over the texture."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / np.float32(size)
    row = np.floor(y * 16)
    heights = [
        ((x * 8 % 1.0 > 0.06) & (y * 8 % 1.0 > 0.06)).astype(np.float32),
        ((y * 16 % 1.0 > 0.1)
         & ((x * 8 + 0.5 * (row % 2)) % 1.0 > 0.05)).astype(np.float32),
        0.5 + 0.4 * np.sign(np.sin(2 * np.pi * 6 * x)),
        0.5 + 0.5 * np.sin(2 * np.pi * (3 * x + 0.4 * np.sin(2 * np.pi * 2 * y))),
    ]
    normals = []
    for h in heights:
        gy, gx = np.gradient(h)
        inv = 1.0 / np.sqrt(4.0 * (gx * gx + gy * gy) + 1.0)
        normals.append(rgba(np.stack([-2.0 * gx * inv, -2.0 * gy * inv, inv],
                                     -1) * 0.5 + 0.5))
    cell = (y * 8).astype(np.int64) % 8 * 8 + (x * 8).astype(np.int64) % 8
    return heights, normals, cell


def image_set(rng, kind: int, tint, rough: float, metal: float,
              pats) -> list[dict]:
    """A material's three textures: base colour (sRGB) of its tint over
    pattern `kind` (`patterns`), each cell of the texture's 8 x 8 grid a
    little darker or lighter; metallic-roughness and normal map
    (linear)."""
    heights, normals, cell = pats
    h = heights[kind]
    shade = (0.55 + 0.45 * h) * rng.uniform(0.85, 1.0, 64).astype(
        np.float32)[cell]
    base = np.asarray(tint, np.float32) * shade[..., None]
    mr = np.stack(np.broadcast_arrays(
        np.float32(0.0), np.clip(rough + 0.25 * (1.0 - h), 0.05, 1.0),
        np.float32(metal)), -1)
    return [{"pixels": px, "srgb": srgb, "wrap": (REPEAT, REPEAT)}
            for px, srgb in ((rgba(base), True), (rgba(mr), False),
                             (normals[kind], False))]


def png_fast(pixels: np.ndarray) -> bytes:
    """(H, W, 4) uint8 -> an RGBA PNG, filter 0, zlib level 1."""
    h, w = pixels.shape[:2]
    raw = np.zeros((h, 1 + 4 * w), np.uint8)
    raw[:, 1:] = pixels.reshape(h, -1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def make_inputs(triangles: int, scatter_lights: int, light_range: float,
                layout_seed: int, texture_size: int, seed: int) -> dict:
    """The arrays of the atrium of `layout_seed` at `triangles` world
    triangles, its lights in the order that `seed` draws, written as a
    glTF file (see the module docstring)."""
    rng = np.random.default_rng(layout_seed)
    detail = float(np.sqrt(triangles / FULL_BUDGET))
    nodes_of = placements()
    n_columns = 4 * len(COLUMN_X)
    uses = {name: sum(m == name for m, *_ in nodes_of) for name in MESH_ORDER}
    uses["column"] = n_columns
    sized = meshes_of(detail, None)
    rest = triangles - sum(len(sized[k]["indices"]) * uses[k]
                           for k in MESH_ORDER if k != "floor")
    built = meshes_of(detail, rest)
    meshes = [dict(built[name], name=name, material=k)
              for k, name in enumerate(MESH_ORDER)]
    index = {name: k for k, name in enumerate(MESH_ORDER)}

    def node(mesh, translation, rotation=(0, 0, 0, 1), scale=(1, 1, 1),
             children=()):
        return {"mesh": mesh, "translation": np.float32(translation),
                "rotation": np.float32(rotation), "scale": np.float32(scale),
                "children": list(children)}

    nodes = [node(index[m], t, r, s) for m, t, r, s in nodes_of]
    # the columns, under a parent node; every third reflected
    parent_t = np.float32([0.25, 0.0, -0.5])
    first = len(nodes) + 1
    nodes.append(node(None, parent_t, children=range(first, first + n_columns)))
    k = 0
    for side in (-1, 1):
        for storey in range(2):
            for x in COLUMN_X:
                t = np.float32([x, storey * STOREY, side * COLONNADE_Z])
                nodes.append(node(index["column"], t - parent_t,
                                  scale=(-1.0 if k % 3 == 1 else 1.0, 1.0, 1.0)))
                k += 1
    roots = list(range(first))

    lo = np.float32([-HALF_X, 0.0, -HALF_Z])
    hi = np.float32([HALF_X, 2 * STOREY, HALF_Z])
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

    m = len(MESH_ORDER)
    tint = rng.uniform(0.35, 0.95, (m, 3)).astype(np.float32)
    rough = rng.uniform(0.3, 0.8, m).astype(np.float32)
    metal = np.float32([name == "vase" for name in MESH_ORDER])
    pats = patterns(texture_size)
    imgs = []
    for k in range(m):
        imgs += image_set(rng, k % 4, tint[k], float(rough[k]),
                          float(metal[k]), pats)
    materials = {
        "base_color_factor": np.concatenate([np.ones((m, 3)), np.ones((m, 1))],
                                            1).astype(np.float32),
        "metallic_factor": np.ones(m, np.float32),
        "roughness_factor": np.ones(m, np.float32),
        "alpha_cutoff": np.full(m, 0.5, np.float32),
        "alpha_mode": np.zeros(m, np.int32),
        "base_color_tex": np.arange(m, dtype=np.int32) * 3,
        "metallic_roughness_tex": np.arange(m, dtype=np.int32) * 3 + 1,
        "normal_tex": np.arange(m, dtype=np.int32) * 3 + 2,
    }
    doc = {
        "scene": 0,
        "scenes": [{"nodes": roots + list(range(len(nodes), len(nodes) + n))}],
        "nodes": [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in nd.items()
                   if (k != "mesh" or v is not None)
                   and (k != "children" or v)}
                  for nd in nodes] + light_nodes,
        "materials": [
            {"name": name, "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "metallicFactor": 1.0, "roughnessFactor": 1.0,
                "baseColorTexture": {"index": 3 * k},
                "metallicRoughnessTexture": {"index": 3 * k + 1}},
             "normalTexture": {"index": 3 * k + 2}}
            for k, name in enumerate(MESH_ORDER)],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
    }
    directory = tempfile.mkdtemp(prefix="frame_bench_scene_")
    path = write_gltf(directory, doc, meshes, [])
    with open(path) as f:
        doc = json.load(f)
    doc["images"] = []
    for i, img in enumerate(imgs):
        name = f"image{i}.png"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(png_fast(img["pixels"]))
        doc["images"].append({"uri": name})
    doc["samplers"] = [{"wrapS": REPEAT, "wrapT": REPEAT}]
    doc["textures"] = [{"source": i, "sampler": 0} for i in range(len(imgs))]
    with open(path, "w") as f:
        json.dump(doc, f)

    return {
        "gltf": path, "scene_dir": directory,
        "meshes": meshes, "nodes": nodes, "roots": roots,
        "materials": materials, "images": imgs,
        "sun_irradiance": SUN_IRRADIANCE.copy(),
        "sun_direction": SUN_DIRECTION.copy(),
        "point_position": pos, "point_radiance": radiance,
        "point_radius": radius,
        "eye": (TARGET + EYE).astype(np.float32),
        "target": TARGET.copy(),
    }


def make(config: dict, seed: int) -> dict:
    """The inputs of a configuration file whose generator is
    "gltf_atrium": the atrium of its `layout_seed` at its `triangles`,
    its lights in the order that the run's seed draws."""
    return make_inputs(int(config["triangles"]), int(config["scatter_lights"]),
                       float(config["light_range"]), int(config["layout_seed"]),
                       int(config["texture_size"]), int(seed))
