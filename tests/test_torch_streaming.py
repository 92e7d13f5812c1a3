"""Asset streaming of prosper_tpu_torch against prosper_tpu on the CPU:
scene/streaming.py's worker (meshes before textures, the per-poll
budget, a poll that never waits), World(streaming=True) before and after
its meshes arrive, the streaming texture arena and arena_write.

The scenes are tests/test_torch_world.py's feature scene (as .gltf and
.glb: five images of several sizes, sRGB and linear, several meshes and
primitives), written once per package. Everything here is the same numpy
code on the same file, so every comparison is exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

from prosper_tpu.scene.gltf import load_gltf as j_load_gltf
from prosper_tpu.scene.textures import build_streaming_arena as j_streaming
from prosper_tpu.scene.world import World as JWorld
from prosper_tpu_torch.scene.gltf import load_gltf
from prosper_tpu_torch.scene.streaming import (
    LoadedMesh,
    LoadedTexture,
    StreamingContext,
)
from prosper_tpu_torch.scene.textures import (
    arena_write,
    build_streaming_arena,
    build_texture_arena,
)
from prosper_tpu_torch.scene.world import World
from tests.test_torch_world import _assert_tree_equal, _scene_pair

torch.set_num_threads(2)
DEADLINE_S = 60


def _poll_until_done(world, budget=2) -> int:
    adopted = 0
    deadline = time.monotonic() + DEADLINE_S
    while not world.streaming_done and time.monotonic() < deadline:
        adopted += world.poll_streaming(budget=budget)
        time.sleep(0.005)
    assert world.streaming_done
    return adopted


def test_streaming_context_order_and_budget():
    """Meshes first, then textures, at most `budget` a poll; a poll
    returns at once while the worker is still busy."""
    gate = threading.Event()

    def mesh(i):
        def job():
            if i == 0:
                assert gate.wait(DEADLINE_S)
            return LoadedMesh(mesh_index=i, arrays={})
        return job

    def tex(i):
        return lambda: LoadedTexture(image_index=i, offset=i,
                                     chunk=np.zeros((1, 4), np.uint32))

    ctx = StreamingContext([mesh(i) for i in range(5)],
                           [tex(i) for i in range(3)])
    ctx.start()
    t0 = time.monotonic()
    assert ctx.poll() == [] and time.monotonic() - t0 < 1.0
    assert not ctx.done
    gate.set()
    got, sizes = [], []
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.done and time.monotonic() < deadline:
        items = ctx.poll(budget=3)
        sizes.append(len(items))
        got += items
        time.sleep(0.005)
    assert ctx.done and max(sizes) <= 3
    assert [type(i).__name__ for i in got] == ["LoadedMesh"] * 5 + [
        "LoadedTexture"] * 3
    assert [i.mesh_index for i in got[:5]] == list(range(5))
    assert (ctx.meshes_loaded, ctx.textures_loaded) == (5, 3)


@pytest.mark.parametrize("name", ["features", "features_glb"])
def test_streaming_world_matches_jax(tmp_path, name):
    """Before streaming: the placeholder arrays equal JAX's streaming
    World's (no cluster has a triangle); polled to the end: both equal
    the port's and JAX's loaded Worlds, and every mesh was adopted."""
    path_j, path_t = _scene_pair(tmp_path, name)
    jw = JWorld(path_j, use_cache=False, streaming=True)
    tw = World(path_t, use_cache=False, streaming=True)
    _assert_tree_equal(tw.static_scene_arrays(), jw.static_scene_arrays(),
                       "placeholders")
    assert (tw.wc_tri_count == 0).all() and not tw.wt_p0.any()
    _assert_tree_equal(tw.frame_arrays(0.0), jw.frame_arrays(0.0),
                       "placeholder frame")
    for w in (tw, jw):
        w.start_streaming()
    n_t, n_j = _poll_until_done(tw), _poll_until_done(jw)
    assert n_t == n_j == len(tw.meshes) and tw.streaming_dirty
    full = World(path_t, use_cache=False)
    for other, where in ((full, "port"), (JWorld(path_j, use_cache=False),
                                          "jax")):
        _assert_tree_equal(tw.static_scene_arrays(),
                           other.static_scene_arrays(), f"streamed/{where}")
        _assert_tree_equal(tw.frame_arrays(0.7), other.frame_arrays(0.7),
                           f"streamed frame/{where}")


def test_placeholders_reserve_the_adopted_clusters(tmp_path):
    """On 8x8-quad plates, whose meshlets are not 124-triangle ranges,
    each placeholder reserves the clusters its adoption fills, so the
    arena's layout does not move; streamed to the end, the World equals
    the loaded one."""
    from prosper_tpu_torch import testing

    path = testing.write_plate_gltf(tmp_path, n_clusters=27, n_instanced=3,
                                    scatter_lights=8)
    full = World(path, use_cache=False)
    tw = World(path, use_cache=False, streaming=True)
    assert [len(m.clusters.cluster_count) for m in tw.meshes] == [
        len(m.clusters.cluster_count) for m in full.meshes]
    assert any(len(m.clusters.cluster_count) * 124 > len(m.clusters.tri_vidx)
               + 124 for m in full.meshes)  # more than ceil(T / 124)
    layout = ("wc_instance", "wc_material", "wt_instance", "wt_material")
    before = {k: v for k, v in tw.static_scene_arrays().items() if k in layout}
    assert (tw.wc_tri_count == 0).all()
    tw.start_streaming()
    assert _poll_until_done(tw) == len(tw.meshes)
    for k, v in before.items():
        np.testing.assert_array_equal(tw.static_scene_arrays()[k], v, k)
    _assert_tree_equal(tw.static_scene_arrays(), full.static_scene_arrays(),
                       "streamed")
    _assert_tree_equal(tw.frame_arrays(0.0), full.frame_arrays(0.0),
                       "streamed frame")
    assert tw.meshlet_counters == full.meshlet_counters


@pytest.mark.parametrize("name", ["features", "features_glb"])
def test_streaming_arena_matches_jax(tmp_path, name):
    """The table, mip counts, neutral contents and every job's (offset,
    chunk) of build_streaming_arena equal JAX's."""
    path_j, path_t = _scene_pair(tmp_path, name)
    got, got_jobs = build_streaming_arena(load_gltf(path_t), max_dim=16)
    want, want_jobs = j_streaming(j_load_gltf(path_j), max_dim=16)
    _assert_tree_equal(got.uniforms(), want.uniforms(), "arena")
    assert len(got_jobs) == len(want_jobs) == 5
    for g, w in zip(got_jobs, want_jobs):
        g, w = g(), w()
        assert (g.image_index, g.offset) == (w.image_index, w.offset)
        np.testing.assert_array_equal(g.chunk, w.chunk)
        assert g.chunk.dtype == w.chunk.dtype == np.uint32


@pytest.mark.parametrize("max_dim", [None, 16])
def test_arena_write_gives_the_full_arena(tmp_path, max_dim):
    """Every job's chunk written with arena_write over the streaming
    arena's tensor (int64 words, in place) gives build_texture_arena's
    data bit for bit; a chunk past the end is refused."""
    _, path = _scene_pair(tmp_path, "features")
    doc = load_gltf(path)
    arena, jobs = build_streaming_arena(doc, max_dim=max_dim)
    full = build_texture_arena(doc, max_dim=max_dim)
    np.testing.assert_array_equal(arena.table, full.table)
    data = torch.as_tensor(arena.data.astype(np.int64))
    ptr = data.data_ptr()
    assert not np.array_equal(arena.data, full.data)
    for job in jobs:
        tex = job()
        assert arena_write(data, tex.chunk, tex.offset) is data
    assert data.data_ptr() == ptr
    np.testing.assert_array_equal(data.numpy(), full.data.astype(np.int64))
    with pytest.raises(ValueError, match="outside"):
        arena_write(data, np.zeros((2, 4), np.uint32), data.shape[0] - 1)
