"""The plain PyTorch versions of the three trace kernels
(prosper_tpu_torch.ops.trace_bvh) against the Pallas kernels of
prosper_tpu.ops.trace_bvh, run in interpret mode on the CPU as
tests/test_trace_bvh.py runs them.

The Pallas kernels ignore t_min (1e-4 closest, 0.1 any-hit); the port
honours it, so these tests pass those values. Tolerances: hit/miss, tri
ids and occlusion exact; t within rtol 1e-5 (float32 Möller, the same
expression order); interpolated attributes within 1e-4."""

from contextlib import contextmanager
from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.accel.bvh import build_bvh, pack_nodes
from prosper_tpu.ops import trace, trace_pallas
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.ops import trace_pallas_full
from prosper_tpu.testing import make_test_scene
from prosper_tpu_torch.ops import trace_bvh as ttb
from tests.test_trace import _random_scene

torch.set_num_threads(2)


@contextmanager
def interpret_mode():
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        yield


def _t(a):
    return torch.as_tensor(np.array(a), device="cpu")


def _rays(seed, R, spread=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _scene(kind, seed):
    """(packed (C, 9, 128), bounds, meta) numpy for a random triangle
    soup or the box test scene."""
    if kind == "random":
        tris, wc_min, wc_max = _random_scene(n_clusters=6, seed=seed)
        packed = np.asarray(trace_pallas.pack_tris(tris))
        wc_min, wc_max = np.asarray(wc_min), np.asarray(wc_max)
    else:
        static, frame, _, _ = make_test_scene(4, seed)
        tris = trace.world_triangles(
            {k: jnp.asarray(v) for k, v in static.items() if k != "materials"},
            {k: jnp.asarray(frame[k]) for k in ("transforms",)},
        )
        packed = np.asarray(trace_pallas.pack_tris(tris))
        wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bounds, meta = pack_nodes(build_bvh(wc_min, wc_max, max_leaf_size=1))
    return packed, bounds, meta


def _assert_closest(got, want_t, want_tri):
    """got (R, 8) port rows vs the Pallas hit dict."""
    got = got.numpy()
    want_tri = np.asarray(want_tri)
    np.testing.assert_array_equal(got[:, 1].astype(np.int32), want_tri)
    sel = want_tri >= 0
    assert sel.any()
    np.testing.assert_allclose(got[sel, 0], np.asarray(want_t)[sel],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 7),
                                       ("boxes", 0)])
def test_closest_plain_matches_pallas(kind, seed):
    packed, bounds, meta = _scene(kind, seed)
    o, d = _rays(seed + 1, 2 * trace.TILE, 8.0 if kind == "random" else 4.0)
    t_max = np.full((o.shape[0],), np.inf, np.float32)
    t_max[::7] = 0.0  # dead rays
    t_max[1::7] = 3.0  # finite budgets
    with interpret_mode():
        want = jtb.trace_closest_bvh(
            jnp.asarray(packed), jnp.asarray(bounds), jnp.asarray(meta),
            jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_max),
        )
    got = ttb.trace_closest_bvh(_t(packed), _t(bounds), _t(meta), _t(o),
                                _t(d), 1e-4, _t(t_max))
    _assert_closest(got, want["t"], want["tri"])
    sel = np.asarray(want["tri"]) >= 0
    np.testing.assert_allclose(got.numpy()[sel, 2], np.asarray(want["u"])[sel],
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy()[sel, 3], np.asarray(want["v"])[sel],
                               atol=1e-4)
    # misses: t = t_max, tri = -1, zero barycentrics
    miss = ~sel
    np.testing.assert_array_equal(got.numpy()[miss, 0], t_max[miss])
    assert (got.numpy()[miss, 2:] == 0).all()


@pytest.mark.parametrize("kind,seed", [("random", 3), ("boxes", 1)])
def test_any_plain_matches_pallas(kind, seed):
    packed, bounds, meta = _scene(kind, seed)
    o, d = _rays(seed + 4, trace.TILE, 8.0 if kind == "random" else 4.0)
    t_max = np.full((o.shape[0],), 6.0, np.float32)
    t_max[::5] = 0.0
    with interpret_mode():
        want = jtb.trace_any_bvh(
            jnp.asarray(packed), jnp.asarray(bounds), jnp.asarray(meta),
            jnp.asarray(o), jnp.asarray(d), 0.1, jnp.asarray(t_max),
        )
    got = ttb.trace_any_bvh(_t(packed), _t(bounds), _t(meta), _t(o), _t(d),
                            0.1, _t(t_max))
    want = np.asarray(want)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_t_min_is_honoured():
    """A hit at t <= t_min is skipped (the Pallas kernels would not)."""
    packed, bounds, meta = _scene("random", 0)
    o, d = _rays(1, 256)
    args = (_t(packed), _t(bounds), _t(meta), _t(o), _t(d))
    near = ttb.trace_closest_bvh(*args, 1e-4, float("inf"))
    hit_t = near[:, 0][near[:, 1] >= 0]
    cut = float(hit_t.median())
    far = ttb.trace_closest_bvh(*args, cut, float("inf"))
    kept = far[:, 1] >= 0
    assert (far[kept, 0] > cut).all()
    # hits at or before the cut are gone, so the rays that had one changed
    early = (near[:, 1] >= 0) & (near[:, 0] <= cut)
    assert early.any()
    assert (far[early, 1] != near[early, 1]).all()


def test_primary_plain_matches_pallas():
    """K1 on the box scene at 48x48 (9 tiles, 7 pad tiles): tri exact,
    t rtol 1e-5, attributes 1e-4, pad lanes are dead misses."""
    static, frame, _, cam_fn = make_test_scene(4)
    jstatic = {k: jnp.asarray(v) for k, v in static.items() if k != "materials"}
    jframe = {k: jnp.asarray(v) for k, v in frame.items() if k != "lights"}
    W = H = 48
    cam = cam_fn(W, H)
    px, py, _ = trace.block_pixel_order(W, H)
    cols, R0 = jtb.pack_pixels_np(px, py)[0::2]
    packed = trace_pallas_full.pack_tris_full(jstatic, jframe,
                                              dtype=jnp.float32)
    cam_vec = jtb.primary_cam_vec({k: jnp.asarray(v) for k, v in cam.items()},
                                  W, H)
    with interpret_mode():
        want = np.asarray(jtb.trace_primary_bvh_full(
            packed, jframe["bvh_bounds"], jframe["bvh_meta"],
            jnp.asarray(cols), jnp.asarray(jtb.pack_pixels_np(px, py)[1]),
            cam_vec, jnp.array([[3, 0, 0, 0]], jnp.int32),
        ))
    tcols, tR0 = ttb.pack_pixels_np(px, py)
    assert tR0 == R0
    np.testing.assert_array_equal(tcols, cols)
    got = ttb.trace_primary_bvh_full(
        _t(packed), _t(frame["bvh_bounds"]), _t(frame["bvh_meta"]),
        _t(tcols), ttb.primary_cam_vec(cam, W, H), 3, 1e-4,
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    sel = want[:, 1] >= 0
    assert sel[:R0].mean() > 0.05
    np.testing.assert_allclose(got[sel, 0], want[sel, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 2:13], want[:, 2:13], atol=1e-4)
    assert (got[R0:, 1] == -1.0).all() and (got[R0:, 0] == 0.0).all()


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain version and leave the launch counts
    alone; a device that is neither CPU nor CUDA is refused."""
    packed, bounds, meta = _scene("random", 0)
    o, d = _rays(2, 64)
    ttb.reset_launch_counts()
    ttb.trace_closest_bvh(_t(packed), _t(bounds), _t(meta), _t(o), _t(d),
                          0.0, float("inf"))
    ttb.trace_any_bvh(_t(packed), _t(bounds), _t(meta), _t(o), _t(d), 0.1,
                      5.0)
    assert [f.launches for f in ttb.KERNELS] == [0] * len(ttb.KERNELS)
    meta_o = torch.empty((64, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttb.trace_closest_bvh(_t(packed), _t(bounds), _t(meta), meta_o,
                              meta_o, 0.0, float("inf"))
    with pytest.raises(ValueError, match="unsupported device"):
        ttb.trace_closest_bvh_full(_t(packed), _t(bounds), _t(meta), meta_o,
                                   meta_o, 1e-4, float("inf"))
