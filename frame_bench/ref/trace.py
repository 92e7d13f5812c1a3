"""The scene's world-space triangles, and ray casting against them, in
plain PyTorch.

`scene_slots` lays out a generator's inputs, in either of its forms, as
world-space triangles in groups of 128 slots, one group a cluster:

- the plate form: the arrays' own clusters (rows [128 c, 128 c + 128),
  every slot real), in world space;
- the glTF form: the program's clusters, read after the window
  (`check_clusters`: an exact cover of the input's triangles, each
  cluster of at most 124 triangles and 64 vertices, as upstream's
  meshlets, src/utils/Utils.hpp:18-19), each triangle worked out again from the
  input: its mesh's vertices packed as upstream packs them (positions
  and uvs in float16, normals and tangents in 10-10-10-2 snorm,
  Mesh.hpp:11-15, DeferredLoadingContext.cpp:442-490) and placed by its
  node's transform, composed down the node tree from each node's
  translation, rotation and scale (World.cpp:359-466), normals by the
  inverse transpose. A reflected node (scale (-1, 1, 1)) thus turns
  each triangle's winding over against its normals, as upstream's does.

With the triangles come each slot's corner attributes (normal, tangent
and sign, uv), material and texture LOD term, and each cluster's bounds
for the culler: for the plate form the box's centre and half diagonal
(as the harness hands the plate to the program) and no cone; for the
glTF form, from the input's positions before packing, as the port's
meshlet builder makes them (cpp/asset_pipeline.cpp cluster_bounds, a
departure from meshopt's bounds): the box's centre, the farthest corner
from it, the normalised sum of the facet normals and the cutoff
sqrt(1 - min_dot^2) (1, never culled, where a facet faces away from the
axis), then placed by the instance.

Each group's box is worked out from its corners. A block of rays
is tested against every group's box, the groups a ray enters are sorted
by entry distance, and the rays then test the 128 triangles of their
k-th group in rounds (Möller-Trumbore, both faces) until no ray has a
group left that could hold a nearer hit (closest hit) or every ray has
found one (any hit). A hit lies strictly between t_min and t_max.
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 128
MESHLET_TRIANGLES = 124  # upstream's meshlet limits (Utils.hpp:18-19)
MESHLET_VERTICES = 64


class Triangles:
    """The scene's triangles on a device: v0, e1, e2 as (G, 128, 3), the
    real slots `real` (G, 128) (the first count[g] of group g; all
    without counts) and each group's box (G, 3) x 2 over them."""

    def __init__(self, p0, p1, p2, device, counts=None):
        p0, p1, p2 = (torch.as_tensor(p, dtype=torch.float32, device=device)
                      for p in (p0, p1, p2))
        G = p0.shape[0] // GROUP
        self.v0 = p0.reshape(G, GROUP, 3)
        self.e1 = (p1 - p0).reshape(G, GROUP, 3)
        self.e2 = (p2 - p0).reshape(G, GROUP, 3)
        corners = torch.stack([p0, p1, p2], 1).reshape(G, GROUP, 3, 3)
        self.real = None
        if counts is not None:
            counts = torch.as_tensor(np.asarray(counts), device=device)
            self.real = (torch.arange(GROUP, device=device)[None, :]
                         < counts[:, None])
            keep = self.real[:, :, None, None]
            lo = torch.where(keep, corners, float("inf"))
            hi = torch.where(keep, corners, float("-inf"))
        else:
            lo = hi = corners
        self.lo = lo.reshape(G, GROUP * 3, 3).amin(1)
        self.hi = hi.reshape(G, GROUP * 3, 3).amax(1)
        self.device = torch.device(device)

    @classmethod
    def from_slots(cls, slots: dict, device) -> "Triangles":
        """The triangles of trace.scene_slots's slots, with each group's
        world-space bounds for the culler: center, radius, axis, cutoff."""
        counts = slots["count"]
        full = bool((np.asarray(counts) == GROUP).all())
        tris = cls(slots["p0"], slots["p1"], slots["p2"], device,
                   None if full else counts)
        for k in ("center", "radius", "axis", "cutoff"):
            setattr(tris, k, torch.as_tensor(slots[k], device=device))
        return tris

    def chunk(self) -> int:
        return 32768 if self.device.type == "cuda" else 2048


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _group_hits(tris: Triangles, g, o, d):
    """(t, u, v, hit) of rays o, d (A, 3) against the 128 triangles of
    group g (A,) each: (A, 128)."""
    v0, e1, e2 = tris.v0[g], tris.e1[g], tris.e2[g]
    o, d = o[:, None, :], d[:, None, :]
    real = True if tris.real is None else tris.real[g]
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv = 1.0 / torch.where(det != 0, det, 1.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & real
    return t, u, v, hit


def _entries(tris: Triangles, o, d, t_min, t_max, groups=None):
    """Groups (those `groups` (G,) bool keeps, or all) sorted by the
    distance at which each ray enters their box: (sorted entry
    distances, group ids, count of boxes entered)."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    near = far = None
    for ax in range(3):
        a = (tris.lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        b = (tris.hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    ok = ((near <= far) & (far > t_min) & (near < t_max[:, None])
          & (t_max > t_min)[:, None])
    if groups is not None:
        ok &= groups[None, :]
    key = torch.where(ok, near, float("inf"))
    keys, order = torch.sort(key, dim=1)
    return keys, order, ok.sum(1)


def trace(tris: Triangles, o, d, t_min: float, t_max, any_hit: bool,
          groups=None):
    """Rays o, d (R, 3) float32; t_max (R,) -> closest hit (t, tri, u,
    v) per ray (t = t_max, tri = -1 without one), or with any_hit the
    (R,) bool occlusion; over the groups that `groups` (G,) bool keeps,
    or all."""
    R = o.shape[0]
    dev = o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(R).contiguous()
    out_t = t_max.clone()
    out_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(R, dtype=torch.float32, device=dev)
    out_v = torch.zeros(R, dtype=torch.float32, device=dev)
    step = tris.chunk()
    for r0 in range(0, R, step):
        sl = slice(r0, min(R, r0 + step))
        oo, dd, best = o[sl], d[sl], out_t[sl].clone()
        tri = torch.full_like(out_tri[sl], -1)
        uu, vv = torch.zeros_like(best), torch.zeros_like(best)
        keys, order, n = _entries(tris, oo, dd, t_min, best, groups)
        for j in range(int(n.max()) if n.numel() else 0):
            act = (n > j) & (keys[:, j] < best)
            if any_hit:
                act &= tri < 0
            idx = act.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            g = order[idx, j]
            t, u, v, hit = _group_hits(tris, g, oo[idx], dd[idx])
            ok = hit & (t > t_min) & (t < best[idx, None])
            t = torch.where(ok, t, float("inf"))
            tbest, lane = t.min(1)
            better = tbest < best[idx]
            idx, lane = idx[better], lane[better]
            best[idx] = tbest[better]
            tri[idx] = g[better] * GROUP + lane
            rows = better.nonzero().squeeze(1)
            uu[idx] = u[rows, lane]
            vv[idx] = v[rows, lane]
        out_t[sl], out_tri[sl], out_u[sl], out_v[sl] = best, tri, uu, vv
    if any_hit:
        return out_tri >= 0
    return out_t, out_tri, out_u, out_v


def snorm10(v) -> np.ndarray:
    """Values through a 10-bit snorm channel: round(clamp(v) * 511) /
    511, half to even, as the packing rounds."""
    q = np.rint(np.clip(np.asarray(v, np.float32), -1.0, 1.0) * 511.0)
    return np.maximum(q.astype(np.float32) / np.float32(511.0), -1.0)


def packed_mesh(mesh: dict) -> dict:
    """A mesh's vertex attributes as upstream packs them: positions and
    uvs through float16, unit normals and tangents through 10-10-10-2
    snorm (the tangent's sign through 2-bit snorm)."""
    def unit(v):
        v = np.asarray(v, np.float32)
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              np.float32(1e-20))

    t = np.asarray(mesh["tangents"], np.float32)
    sign = np.maximum(np.rint(np.clip(t[:, 3], -1.0, 1.0)), -1.0)
    return {
        "positions": np.asarray(mesh["positions"], np.float16).astype(np.float32),
        "normals": snorm10(unit(mesh["normals"])),
        "tangents": np.concatenate([snorm10(unit(t[:, :3])),
                                    sign[:, None].astype(np.float32)], 1),
        "uv": np.asarray(mesh["uv"], np.float16).astype(np.float32),
    }


def trs_matrix(node: dict) -> np.ndarray:
    """A node's local 4x4 matrix, translation * rotation * scale, in
    float64 (the glTF quaternion x, y, z, w)."""
    x, y, z, w = np.asarray(node["rotation"], np.float64)
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    r = np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(node["scale"], np.float64)[None, :]
    m[:3, 3] = np.asarray(node["translation"], np.float64)
    return m


def instances(nodes: list, roots: list) -> list[tuple[int, np.ndarray]]:
    """(mesh, model-to-world 4x4 float64) of each node with a mesh, in
    the order a depth-first walk from the roots meets them (a node
    before its children, children in order)."""
    out = []
    stack = [(r, np.eye(4)) for r in reversed(roots)]
    while stack:
        i, parent = stack.pop()
        m = parent @ trs_matrix(nodes[i])
        if nodes[i].get("mesh") is not None:
            out.append((int(nodes[i]["mesh"]), m))
        stack.extend((c, m) for c in reversed(nodes[i].get("children", [])))
    return out


def _groups(keys: np.ndarray):
    """(key, the indices that hold it) for each distinct key, ascending."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    cuts = np.flatnonzero(np.diff(k)) + 1
    return [(int(g[0]), order[a:b]) for g, a, b in zip(
        np.split(k, cuts), np.r_[0, cuts], np.r_[cuts, len(k)])]


class ClusterError(ValueError):
    """The program's clusters are no exact cover of the input's
    triangles, or break upstream's meshlet limits."""


def check_clusters(meshes: list, insts: list, clusters: dict):
    """The program's clusters, checked and read as input triangles.

    clusters: the program's wt_aidx (C * 128, 3) (vertex rows of its
    attribute arena, which holds the meshes' vertices one mesh after
    the other, each in its own order), wc_tri_count (C,) and
    wc_instance (C,). Each real slot must name three vertices of one
    mesh, the mesh of its cluster's instance, in the order of one of
    that mesh's triangles; every (instance, triangle) must be named
    exactly once; no cluster may hold more than 124 triangles or 64
    distinct vertices (upstream's meshlet limits). Raises ClusterError
    otherwise. Returns, per slot, the instance and the
    triangle (-1 on padding), and the largest number of distinct
    vertices in one cluster."""
    aidx = np.asarray(clusters["wt_aidx"], np.int64)
    count = np.asarray(clusters["wc_tri_count"], np.int64)
    inst = np.asarray(clusters["wc_instance"], np.int64)
    C = count.shape[0]
    if aidx.shape[0] != C * GROUP or (count > MESHLET_TRIANGLES).any() \
            or (count < 0).any():
        raise ClusterError(f"cluster sizes {count.min()}..{count.max()} "
                           f"triangles over {aidx.shape[0]} slots "
                           f"(at most {MESHLET_TRIANGLES})")
    real = (np.arange(GROUP)[None, :] < count[:, None]).reshape(-1)
    # distinct vertex rows of each cluster's real slots
    rows = np.sort(np.where(real[:, None], aidx, -1).reshape(C, -1), axis=1)
    verts = ((np.diff(rows, axis=1) != 0).sum(1) + 1
             - (rows[:, 0] < 0)) if C else np.zeros(0, np.int64)
    most = int(verts.max(initial=0))
    if most > MESHLET_VERTICES:
        raise ClusterError(
            f"{int((verts > MESHLET_VERTICES).sum())} of {C} clusters hold "
            f"more than {MESHLET_VERTICES} vertices (at most {most})")
    if ((inst < 0) | (inst >= len(insts))).any():
        raise ClusterError("a cluster names no instance")
    vcount = np.array([len(m["positions"]) for m in meshes], np.int64)
    voff = np.concatenate([[0], np.cumsum(vcount)])
    tcount = np.array([len(m["indices"]) for m in meshes], np.int64)
    inst_mesh = np.array([mi for mi, _ in insts], np.int64)
    inst_first = np.concatenate([[0], np.cumsum(tcount[inst_mesh])])

    slot_inst = np.repeat(inst, GROUP)
    slot_tri = np.full(C * GROUP, -1, np.int64)
    rows = aidx[real]
    mesh = inst_mesh[slot_inst[real]]
    local = rows - voff[mesh][:, None]
    if ((local < 0) | (local >= vcount[mesh][:, None])).any():
        raise ClusterError("a slot names vertices outside its instance's mesh")
    tri = np.full(rows.shape[0], -1, np.int64)
    for m, sel in _groups(mesh):
        idx = np.asarray(meshes[m]["indices"], np.int64)
        v = int(vcount[m])
        keys = (idx[:, 0] * v + idx[:, 1]) * v + idx[:, 2]
        order = np.argsort(keys, kind="stable")
        want = (local[sel, 0] * v + local[sel, 1]) * v + local[sel, 2]
        at = np.clip(np.searchsorted(keys, want, sorter=order), 0,
                     len(keys) - 1)
        hit = keys[order[at]] == want
        tri[sel] = np.where(hit, order[at], -1)
    if (tri < 0).any():
        raise ClusterError("a slot names no triangle of its mesh")
    covered = np.bincount(inst_first[slot_inst[real]] + tri,
                          minlength=int(inst_first[-1]))
    if covered.shape[0] != inst_first[-1] or (covered != 1).any():
        raise ClusterError("the clusters do not cover every triangle of "
                           "every instance exactly once")
    slot_tri[real] = tri
    return slot_inst, slot_tri, most


def _cluster_bounds(p0, p1, p2, real):
    """(center, radius, axis, cutoff) of each group of 128 slots over its
    real ones, as the port's meshlet builder makes them (see the module
    docstring), in float64."""
    corners = np.stack([p0, p1, p2], 1).astype(np.float64)  # (S, 3, 3)
    G = corners.shape[0] // GROUP
    keep = real.reshape(G, GROUP)
    c = corners.reshape(G, GROUP, 3, 3)
    lo = np.where(keep[:, :, None, None], c, np.inf).min((1, 2))
    hi = np.where(keep[:, :, None, None], c, -np.inf).max((1, 2))
    center = (lo + hi) * 0.5
    d2 = ((c - center[:, None, None, :]) ** 2).sum(-1)
    radius = np.sqrt(np.where(keep[:, :, None], d2, 0.0).max((1, 2)))
    fn = np.cross(c[:, :, 1] - c[:, :, 0], c[:, :, 2] - c[:, :, 0])
    fn = np.where(keep[:, :, None], fn, 0.0)
    axis = fn.sum(1)
    alen = np.linalg.norm(axis, axis=1)
    flat = alen < 1e-12
    axis = np.where(flat[:, None], [0.0, 0.0, 1.0],
                    axis / np.where(flat, 1.0, alen)[:, None])
    flen = np.linalg.norm(fn, axis=2)
    unit = fn / np.where(flen > 1e-20, flen, 1.0)[:, :, None]
    unit = np.where((flen > 1e-20)[:, :, None], unit, [0.0, 0.0, 1.0])
    min_dot = np.where(keep, (unit * axis[:, None, :]).sum(-1), 1.0).min(1)
    cutoff = np.where(min_dot <= 0.0, 1.0,
                      np.sqrt(np.maximum(0.0, 1.0 - min_dot * min_dot)))
    cutoff = np.where(flat, 1.0, cutoff)
    return center, radius, axis, cutoff


def scene_slots(inputs: dict, clusters: dict | None = None) -> dict:
    """The world-space slots of either form of inputs (see the module
    docstring) as numpy arrays: p0, p1, p2 (S, 3) float32, count (G,),
    corner_normal (S, 3, 3), corner_tangent (S, 3, 4) (xyz and sign),
    corner_uv (S, 3, 2), material (S,), tri_lod (S,), the clusters'
    world-space bounds center (G, 3), radius (G,), axis (G, 3), cutoff
    (G,), and cluster_vertices (the most distinct vertices of a
    cluster; None for the plate form). clusters: the program's, which
    the glTF form needs."""
    if "gltf" not in inputs:
        return _plate_slots(inputs)
    if clusters is None:
        raise ClusterError("the glTF form needs the program's clusters")
    meshes = inputs["meshes"]
    insts = instances(inputs["nodes"], inputs["roots"])
    slot_inst, slot_tri, most = check_clusters(meshes, insts, clusters)
    S = slot_tri.shape[0]
    real = slot_tri >= 0
    packed = [packed_mesh(m) for m in meshes]
    raw_p = np.zeros((S, 3, 3))  # object-space corners before packing
    p = np.zeros((S, 3, 3))
    n = np.zeros((S, 3, 3))
    t = np.zeros((S, 3, 4))
    uv = np.zeros((S, 3, 2))
    mat = np.zeros(S, np.int64)
    for i, sel in _groups(np.where(real, slot_inst, -1)):
        if i < 0:
            continue
        mi, m4 = insts[i]
        idx = np.asarray(meshes[mi]["indices"], np.int64)[slot_tri[sel]]
        pk = packed[mi]
        m3 = m4[:3, :3]
        nm = np.linalg.inv(m3).T
        raw_p[sel] = np.asarray(meshes[mi]["positions"], np.float64)[idx]
        p[sel] = pk["positions"][idx] @ m3.T + m4[:3, 3]
        n[sel] = pk["normals"][idx] @ nm.T
        t[sel, :, :3] = pk["tangents"][idx, :3] @ m3.T
        t[sel, :, 3] = pk["tangents"][idx, 3]
        uv[sel] = pk["uv"][idx]
        mat[sel] = int(meshes[mi]["material"])
    # bounds: the instance's object-space bounds, placed
    center, radius, axis, cutoff = _cluster_bounds(
        raw_p[:, 0], raw_p[:, 1], raw_p[:, 2], real)
    ci = np.asarray(clusters["wc_instance"], np.int64)
    m4s = np.stack([m for _, m in insts])[ci]  # (G, 4, 4)
    center = np.einsum("gij,gj->gi", m4s[:, :3, :3], center) + m4s[:, :3, 3]
    radius = radius * np.linalg.norm(m4s[:, :3, :3], axis=1).max(1)
    axis = np.einsum("gij,gj->gi", m4s[:, :3, :3], axis)
    axis /= np.maximum(np.linalg.norm(axis, axis=1, keepdims=True), 1e-20)
    f32 = np.float32
    out = {
        "p0": p[:, 0].astype(f32), "p1": p[:, 1].astype(f32),
        "p2": p[:, 2].astype(f32),
        "count": np.asarray(clusters["wc_tri_count"], np.int64),
        "corner_normal": n.astype(f32), "corner_tangent": t.astype(f32),
        "corner_uv": uv.astype(f32), "material": mat,
        "center": center.astype(f32), "radius": radius.astype(f32),
        "axis": axis.astype(f32), "cutoff": cutoff.astype(f32),
        "cluster_vertices": most,
    }
    out["tri_lod"] = _tri_lod(out)
    return out


def _tri_lod(slots: dict) -> np.ndarray:
    """0.5 log2(uv area / world area) of each slot's triangle (its
    texture LOD term, the ray cone's base)."""
    e1 = slots["p1"].astype(np.float64) - slots["p0"]
    e2 = slots["p2"].astype(np.float64) - slots["p0"]
    w_area = np.linalg.norm(np.cross(e1, e2), axis=1)
    uv = slots["corner_uv"].astype(np.float64)
    a, b = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    uv_area = np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    return (0.5 * np.log2(np.maximum(uv_area, 1e-20)
                          / np.maximum(w_area, 1e-20))).astype(np.float32)


def _plate_slots(inputs: dict) -> dict:
    """The slots of the plate form: the arrays' own clusters, 128
    triangles each, in world space."""
    p0, p1, p2 = inputs["p0"], inputs["p1"], inputs["p2"]
    G = p0.shape[0] // GROUP
    a = np.asarray(inputs["a_packed"], np.float32)[np.asarray(inputs["aidx"])]
    f32 = np.float32
    out = {"p0": np.asarray(p0, f32), "p1": np.asarray(p1, f32),
           "p2": np.asarray(p2, f32), "count": np.full(G, GROUP, np.int64),
           "corner_normal": a[..., 0:3], "corner_tangent": a[..., 3:7],
           "corner_uv": a[..., 7:9], "material": np.asarray(
               inputs["tri_material"], np.int64),
           "cluster_vertices": None}
    # the box's centre and half diagonal; no cone (cutoff 1)
    corners = np.stack([out["p0"], out["p1"], out["p2"]], 1).reshape(G, -1, 3)
    lo, hi = corners.min(1), corners.max(1)
    center = (lo + hi) / 2
    out.update(center=center.astype(f32),
               radius=np.linalg.norm(hi - center, axis=1).astype(f32),
               axis=np.tile(np.float32([0, 0, 1]), (G, 1)),
               cutoff=np.ones(G, f32))
    out["tri_lod"] = _tri_lod(out)
    return out
