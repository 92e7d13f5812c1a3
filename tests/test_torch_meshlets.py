"""The port's meshlet builder (prosper_tpu_torch/scene/meshlets.py) on the
CPU: upstream's limits (at most 124 triangles and 64 distinct vertices a
cluster, src/utils/Utils.hpp:18-19) with every triangle in exactly one
cluster, on meshes the old 124-triangle ranges break (8x8-quad plates, a
64x64 grid, a lathe with uv seams, a triangle soup); the JAX package's
partition, bit for bit, on meshes whose old ranges already fit; the
grid's density; the native and numpy bounds; determinism.
"""

import numpy as np
import pytest

from prosper_tpu.scene.meshlets import build_clusters as j_build_clusters
from prosper_tpu_torch import testing
from prosper_tpu_torch.scene import meshlets, native
from prosper_tpu_torch.scene.gltf import load_gltf
from tests.test_torch_world import WRITERS

MAX_T, MAX_V = meshlets.MAX_MESHLET_TRIANGLES, meshlets.MAX_MESHLET_VERTICES


def grid(n: int, seam: int = 0):
    """An n x n quad grid on a gentle wave, (n + 1)^2 vertices; with
    seam, each vertex column at a multiple of `seam` written twice (a uv
    seam)."""
    cols = [i for i in range(n + 1)
            for _ in range(2 if seam and 0 < i < n and i % seam == 0 else 1)]
    pos = np.array([(i, 0.1 * np.sin(0.3 * i + 0.2 * j), j)
                    for i in cols for j in range(n + 1)], np.float32)
    first = {}
    for k, i in enumerate(cols):
        first.setdefault(i, k)  # the copy that ends a tile: quad i - 1's
    tris = []
    for i in range(n):
        lc = first[i] + (1 if cols.count(i) == 2 else 0)
        rc = first[i + 1]
        for j in range(n):
            a, b = lc * (n + 1) + j, rc * (n + 1) + j
            tris += [(a, a + 1, b), (b, a + 1, b + 1)]
    return pos, np.array(tris, np.uint32)


def lathe(rings: int = 40, segs: int = 48, seam: int = 12):
    """A surface of revolution, its uv restarting every `seam` segments
    and at the closing seam (those vertex columns written twice)."""
    cols = [s for s in range(segs + 1)
            for _ in range(2 if 0 < s < segs and s % seam == 0 else 1)]
    y = np.linspace(0.0, 4.0, rings + 1)
    r = 0.3 + 0.1 * np.sin(3 * y)
    a = 2 * np.pi * np.array(cols) / segs
    pos = np.stack([np.outer(np.cos(a), r), np.tile(y, (len(cols), 1)),
                    np.outer(np.sin(a), r)], -1).reshape(-1, 3)
    first = {}
    for k, s in enumerate(cols):
        first.setdefault(s, k)
    tris = []
    for s in range(segs):
        lc = first[s] + (1 if cols.count(s) == 2 else 0)
        rc = first[s + 1]
        for j in range(rings):
            a0, b0 = lc * (rings + 1) + j, rc * (rings + 1) + j
            tris += [(a0, b0, a0 + 1), (b0, b0 + 1, a0 + 1)]
    return pos.astype(np.float32), np.array(tris, np.uint32)


def soup(n: int = 2000, seed: int = 0):
    """n triangles that share no vertex."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(0, 10, (n, 1, 3))
           + rng.normal(0, 0.1, (n, 3, 3))).reshape(-1, 3)
    return pos.astype(np.float32), np.arange(3 * n, dtype=np.uint32).reshape(-1, 3)


def plates8(tmp_path):
    """The 8x8-quad plates of testing.write_plate_gltf (81 vertices, 128
    triangles each) as World reads them: its first primitive."""
    doc = load_gltf(testing.write_plate_gltf(tmp_path, n_clusters=27,
                                             n_instanced=3, scatter_lights=8))
    prim = doc.meshes[0].primitives[0]
    return prim.positions, prim.indices.reshape(-1, 3).astype(np.uint32)


MESHES = {
    "plates8": plates8,
    "grid64": lambda _: grid(64),
    "grid64_seams": lambda _: grid(64, seam=6),
    "lathe": lambda _: lathe(),
    "soup": lambda _: soup(),
}


def _vertex_counts(cl):
    return meshlets.cluster_vertex_counts(cl.tri_vidx, cl.cluster_offset,
                                          cl.cluster_count)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_clusters_keep_the_limits_and_cover_the_mesh(tmp_path, name):
    """Every cluster within 124 triangles and 64 distinct vertices; the
    clusters are contiguous runs that hold each input triangle (with its
    vertex order) exactly once; the old aligned ranges broke the vertex
    limit on these meshes."""
    pos, tris = MESHES[name](tmp_path)
    order, offsets, counts = meshlets.sah_cluster_ranges(pos, tris, MAX_T)
    assert meshlets.cluster_vertex_counts(tris[order], offsets,
                                          counts).max() > MAX_V
    cl = meshlets.build_clusters(pos, tris.reshape(-1))
    counts = cl.cluster_count.astype(np.int64)
    assert counts.min() >= 1 and counts.max() <= MAX_T
    assert _vertex_counts(cl).max() <= MAX_V
    np.testing.assert_array_equal(cl.cluster_offset,
                                  np.cumsum(counts) - counts)
    assert counts.sum() == len(tris)
    got = np.unique(cl.tri_vidx, axis=0, return_counts=True)
    want = np.unique(tris, axis=0, return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_counts_of_hand_made_clusters():
    tris = np.array([[0, 1, 2], [2, 1, 3], [4, 5, 6], [4, 4, 4]], np.uint32)
    got = meshlets.cluster_vertex_counts(tris, np.array([0, 2, 3]),
                                         np.array([2, 1, 1]))
    np.testing.assert_array_equal(got, [4, 3, 1])


def _jax_equal_meshes(tmp_path):
    """The primitives of the World parity scenes (the quad, the feature
    scene as .gltf and .glb), and grids that one old range each already
    fits."""
    out = []
    for name in sorted(WRITERS):
        d = tmp_path / name
        d.mkdir()
        for mesh in load_gltf(WRITERS[name](d)).meshes:
            out += [(p.positions, p.indices) for p in mesh.primitives]
    for n in (1, 4, 6):
        pos, tris = grid(n)
        out.append((pos, tris.reshape(-1)))
    return out


def test_partition_equals_jax_where_the_old_ranges_fit(tmp_path):
    """Where every aligned 124-triangle SAH range holds 64 vertices or
    fewer, build_clusters gives the JAX package's tri_vidx, offsets,
    counts and bounds bit for bit."""
    meshes = _jax_equal_meshes(tmp_path)
    assert len(meshes) >= 8
    for pos, idx in meshes:
        got, want = meshlets.build_clusters(pos, idx), j_build_clusters(pos, idx)
        assert _vertex_counts(got).max() <= MAX_V
        for k in ("tri_vidx", "cluster_offset", "cluster_count", "aabb_min",
                  "aabb_max", "cone_apex", "cone_axis", "cone_cutoff",
                  "sphere_radius"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
            assert getattr(got, k).dtype == getattr(want, k).dtype, k


def test_grid_clusters_are_dense():
    """A 64x64-quad grid averages at least 80 triangles a cluster (row
    strips of 64 vertices would give about 62)."""
    pos, tris = grid(64)
    cl = meshlets.build_clusters(pos, tris.reshape(-1))
    assert len(tris) / len(cl.cluster_count) >= 80


@pytest.mark.parametrize("name", ["grid64_seams", "lathe", "plates8"])
def test_native_and_numpy_bounds_agree(tmp_path, monkeypatch, name):
    """The bounds of one partition by the native library and by numpy:
    boxes and centres exact, radii and axes to float32 rounding, and the
    cutoffs sqrt(1 - min_dot^2) compared squared: near min_dot = 1 the
    square root multiplies min_dot's rounding by min_dot / cutoff."""
    assert native.available()
    pos, tris = MESHES[name](tmp_path)
    nat = meshlets.build_clusters(pos, tris.reshape(-1))
    monkeypatch.setattr(native, "available", lambda: False)
    ref = meshlets.build_clusters(pos, tris.reshape(-1))
    for k in ("tri_vidx", "cluster_offset", "cluster_count", "aabb_min",
              "aabb_max", "cone_apex"):
        np.testing.assert_array_equal(getattr(nat, k), getattr(ref, k),
                                      err_msg=k)
    for k in ("sphere_radius", "cone_axis"):
        np.testing.assert_allclose(getattr(nat, k), getattr(ref, k),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(nat.cone_cutoff ** 2, ref.cone_cutoff ** 2,
                               rtol=1e-5, atol=1e-6)


def test_partition_is_deterministic():
    """The same mesh, and a copy of it, give the same partition."""
    pos, tris = lathe(rings=24, segs=36, seam=9)
    a = meshlets.cluster_ranges(pos, tris)
    b = meshlets.cluster_ranges(pos.copy(), tris.copy())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
