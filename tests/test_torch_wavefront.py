"""The port's X1 and X3a against the JAX package: the threaded table and
the per-ray walk (prosper_tpu_torch/experiments/trace_wavefront.py)
against experiments/trace_wavefront.py, and the visit-counting K2's
plain version (ops/trace_bvh.trace_closest_bvh_visits_plain) against
K2's plain version, brute-force leaf bounds, the Pallas K2's per-packet
visit counts (DEBUG_VISITS) in interpret mode and a numpy recursive walk
(rows and counts bit for bit).

Tolerances: the tables are equal bit for bit (NaN padding included); the
walk's leaves and counts are equal exactly to the Pallas kernel's and
walk_leaves_ref's (the same float32 slab test); the counting walk's rows
0-3 equal K2's plain version except on exact t ties (relative 1e-6, as
chip_smoke.py compares K2), and its counts are integers held to bounds.

experiments/trace_wavefront.py:242 `pack_threaded` uses `np` and `Bvh`
without importing them; the tests patch both into the module.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import trace_wavefront as jtw
from prosper_tpu.accel import bvh as jbvh
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.ops import trace_pallas
from prosper_tpu_torch.accel import bvh as tbvh
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.experiments import trace_wavefront as tw
from prosper_tpu_torch.ops import trace_bvh as tb
from tests.test_trace import _random_scene
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
T_CLOSEST = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _boxes(n, seed, size=(0.02, 0.15)):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(*size, (n, 3)).astype(np.float32)
    return c - h, c + h


def jax_pack_threaded(lo, hi):
    with mock.patch.object(jtw, "np", np, create=True), \
            mock.patch.object(jtw, "Bvh", jbvh.Bvh, create=True):
        return jtw.pack_threaded(jbvh.build_bvh(lo, hi, max_leaf_size=1))


def _rays(R, seed, spread=1.5):
    """Rays from a box around the scene: a finite t_max on a quarter, a
    zero t_max (dead) on some, a zero direction component on every 7th."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1] = 0.0
    tmax = np.full(R, np.inf, np.float32)
    tmax[: R // 4] = rng.uniform(0.1, 2.0, R // 4)
    tmax[R // 4:R // 4 + 40] = 0.0
    return o, d, tmax


@pytest.mark.parametrize("n", [1, 6, 97, 300])
def test_pack_threaded_equals_jax(n):
    """Bit for bit, NaN padding included, and the archived test's
    structure: skips advance, every cluster is one leaf."""
    lo, hi = _boxes(n, n)
    got = tw.pack_threaded(tbvh.build_bvh(lo, hi, max_leaf_size=1))
    want = jax_pack_threaded(lo, hi)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    flat = got.transpose(0, 2, 1).reshape(-1, 8)
    n_nodes = 2 * n - 1
    skip, leaf = flat[:, 6].astype(np.int64), flat[:, 7].astype(np.int64)
    assert (skip[:n_nodes] > np.arange(n_nodes)).all()
    assert (skip <= flat.shape[0]).all()
    assert np.array_equal(np.sort(leaf[leaf >= 0]), np.arange(n))
    assert np.isnan(flat[n_nodes:, 0:6]).all()


@pytest.mark.parametrize("n,seed,size", [
    (31, 0, (0.2, 0.5)), (97, 1, (0.1, 0.4)), (200, 2, (0.05, 0.3))])
def test_walk_plain_equals_jax_walk(n, seed, size):
    """walk_leaves (CPU: the plain lockstep walk) equals the Pallas walk
    in interpret mode and walk_leaves_ref exactly, with l_cap 4 so that
    counts pass it."""
    lo, hi = _boxes(n, seed, size)
    table = jax_pack_threaded(lo, hi)
    o, d, tmax = _rays(1024, seed + 10)
    with interpret_mode():
        want_l, want_c = jtw.walk_leaves(jnp.asarray(table), jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(tmax),
                                         l_cap=4)
    got_l, got_c = tw.walk_leaves(_t(table), _t(o), _t(d), _t(tmax), l_cap=4)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_l.dtype == got_c.dtype == torch.int32
    assert int((got_c > 4).sum()) > 0  # overflow exercised
    assert (got_c[tmax == 0] == 0).all()
    ref_l, ref_c = jtw.walk_leaves_ref(table, o, d, tmax, l_cap=4)
    np.testing.assert_array_equal(got_l.numpy(), ref_l)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)


@functools.lru_cache(maxsize=None)
def _limit_case(n):
    """n seeded boxes and JAX's threaded table of them."""
    rng = np.random.default_rng(n)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    return c - h, c + h, jax_pack_threaded(c - h, c + h)


@pytest.mark.parametrize("l_cap", [1, 5, 32])
@pytest.mark.parametrize("n,path", [(3584, "shared"), (3585, "global")])
def test_walk_path_and_walk_at_the_shared_memory_limit(n, path, l_cap):
    """Tables either side of a block's shared memory: JAX's pack_threaded
    of 3584 boxes gives 56 chunks (229,376 bytes node-major: the kernel
    walks it from shared memory), of 3585 boxes 57 (over: from a copy in
    device memory). The port's table equals JAX's bit for bit, walk_path
    picks by its size, and the walk (on the CPU the plain walk, which
    the card tests hold both kernel paths to) equals walk_leaves_ref at
    l_cap 1, 5 and 32."""
    lo, hi, table = _limit_case(n)
    got_table = tw.pack_threaded(tbvh.build_bvh(lo, hi, max_leaf_size=1))
    np.testing.assert_array_equal(got_table, table)
    assert table.shape[0] == 56 + (path == "global")
    assert tw.walk_path(table.shape[0]) == path
    assert [tw.walk_path(c) for c in (1, 56, 57, 128)] == [
        "shared", "shared", "global", "global"]
    o, d, tmax = _rays(96, n, spread=1.2)
    got_l, got_c = tw.walk_leaves(_t(table), _t(o), _t(d), _t(tmax), l_cap)
    ref_l, ref_c = jtw.walk_leaves_ref(table, o, d, tmax, l_cap=l_cap)
    np.testing.assert_array_equal(got_l.numpy(), ref_l)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    assert int(got_c.max()) > min(l_cap, 5)


def _brute_leaves(bmin, bmax, o, d, tmax):
    inv = np.where(np.abs(d) > 1e-12, 1.0 / np.where(d == 0, 1.0, d), 1e30)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    enter = np.maximum(np.minimum(t0, t1).max(axis=1), 0.0)
    exit_ = np.maximum(t0, t1).min(axis=1)
    return set(np.nonzero((enter <= exit_) & (enter < tmax))[0].tolist())


def test_walk_plain_matches_brute_force():
    """The archived test's brute-force leaf query (l_cap 256: no
    overflow); the steps the walk counts are at least its leaves."""
    lo, hi = _boxes(131, 3)
    table = _t(tw.pack_threaded(tbvh.build_bvh(lo, hi, max_leaf_size=1)))
    o, d, tmax = _rays(64, 7)
    leaves, counts, steps = tw.walk_plain(table, _t(o), _t(d), _t(tmax),
                                          l_cap=256)
    for r in range(64):
        got = set(leaves[r, : counts[r]].tolist())
        want = (_brute_leaves(lo, hi, o[r], d[r], tmax[r])
                if tmax[r] > 0 else set())
        assert got == want, (r, got ^ want)
        assert len(got) == counts[r] and steps[r] >= counts[r]


def _visit_case(n_clusters, seed, R=512):
    tris, wc_min, wc_max = _random_scene(n_clusters=n_clusters, seed=seed)
    packed = np.asarray(trace_pallas.pack_tris(tris))
    bvh = tbvh.build_bvh(np.asarray(wc_min), np.asarray(wc_max),
                         max_leaf_size=1)
    bounds, meta = tbvh.pack_nodes(bvh)
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(R, np.inf, np.float32)
    tmax[::5] = 3.0
    tmax[::11] = 0.0
    return packed, bvh, bounds, meta, o, d, tmax


@pytest.mark.parametrize("n_clusters,seed", [(6, 0), (24, 3), (64, 5)])
def test_visits_plain_rows_and_bounds(n_clusters, seed):
    """The counting walk's rows 0-3 equal K2's plain version but for
    exact t ties; per ray, the leaves it tests are at least those whose
    box the ray enters before its final hit t and at most those it
    enters before t_max (the threaded walk at those t_max); dead rays
    count nothing, and a ray that tests a leaf expanded the root."""
    packed, bvh, bounds, meta, o, d, tmax = _visit_case(n_clusters, seed)
    args = (_t(packed), _t(bounds), _t(meta), _t(o), _t(d), T_CLOSEST,
            _t(tmax))
    rows = tb.trace_closest_bvh_visits(*args)
    ref = tb.trace_closest_bvh_plain(*args[:6], _t(tmax))
    hit = rows[:, 1] >= 0
    assert torch.equal(hit, ref[:, 1] >= 0)
    tie = (rows[:, 0] - ref[:, 0]).abs() <= 1e-6 * ref[:, 0].abs()
    assert bool(((rows[:, 1] == ref[:, 1]) | tie)[hit].all())
    torch.testing.assert_close(rows[:, 0], ref[:, 0], rtol=1e-6, atol=0)
    same = hit & (rows[:, 1] == ref[:, 1])
    torch.testing.assert_close(rows[same, 2:4], ref[same, 2:4], rtol=0,
                               atol=0)
    assert bool((rows[:, 4:6] == 0).all())
    table = _t(tw.pack_threaded(bvh))
    visits, nodes = rows[:, 7].long(), rows[:, 6].long()
    hit_t = torch.where(hit, rows[:, 0], _t(tmax))
    _, needed = tw.walk_leaves(table, _t(o), _t(d), hit_t)
    _, entered = tw.walk_leaves(table, _t(o), _t(d), _t(tmax))
    assert bool((visits >= needed).all()) and bool((visits <= entered).all())
    dead = _t(tmax) <= 0
    assert bool((visits[dead] == 0).all()) and bool((nodes[dead] == 0).all())
    if n_clusters > 1:
        assert bool((nodes[visits > 0] >= 1).all())
    assert int(visits.max()) > 1


def test_jax_packet_visits_cover_the_needed_leaves():
    """The Pallas K2 under DEBUG_VISITS writes each 256-ray packet's leaf
    visits into pad row 7 (trace_bvh.py:941-950); read from the raw rows
    as scripts/bench_visit_breakdown.py:131-153 does, in interpret mode,
    each packet's count is at least the union, over its rays, of the
    leaves entered before the ray's final hit t (the port's threaded walk
    at that t_max, which is Pallas's 1e-4 t_min's hit t here), and at most
    the union of those entered before t_max."""
    packed, bvh, bounds, meta, o, d, tmax = _visit_case(64, 5)
    with interpret_mode(), mock.patch.object(jtb, "DEBUG_VISITS", True):
        jtb.trace_closest_bvh.clear_cache()
        try:
            raw = np.asarray(jtb.trace_closest_bvh(
                jnp.asarray(packed), jnp.asarray(bounds), jnp.asarray(meta),
                jnp.asarray(o), jnp.asarray(d), T_CLOSEST, jnp.asarray(tmax),
                packed=True))
        finally:
            jtb.trace_closest_bvh.clear_cache()
    rows = tb.trace_closest_bvh_visits(_t(packed), _t(bounds), _t(meta),
                                       _t(o), _t(d), T_CLOSEST, _t(tmax))
    torch.testing.assert_close(rows[:, 1], _t(raw[:, 1]), rtol=0, atol=0)
    table = _t(tw.pack_threaded(bvh))
    hit_t = torch.where(rows[:, 1] >= 0, rows[:, 0], _t(tmax))
    need_l, need_c = tw.walk_leaves(table, _t(o), _t(d), hit_t, l_cap=64)
    ent_l, ent_c = tw.walk_leaves(table, _t(o), _t(d), _t(tmax), l_cap=64)
    assert int(ent_c.max()) <= 64
    for p in range(o.shape[0] // 256):
        sl = slice(256 * p, 256 * (p + 1))
        count = raw[sl, 7]
        assert (count == count[0]).all()
        needed = set(need_l[sl].flatten().tolist()) - {-1}
        entered = set(ent_l[sl].flatten().tolist()) - {-1}
        assert len(needed) <= count[0] <= len(entered), (p, count[0])


def _np_slab(o, inv, lo, hi):
    """ops/intersect.slab_enter_exit of one ray and one box in float32."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
    enter = np.maximum(np.maximum(tn[0], tn[1]),
                       np.maximum(tn[2], np.float32(0.0)))
    return enter, np.minimum(np.minimum(tf[0], tf[1]), tf[2])


def _np_moller(slab, o, d, t_min, t_upper):
    """ops/intersect.moller_trumbore of one ray against a (9, 128) slab,
    operation for operation in float32 -> (hit, t, u, v) per lane."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = slab
    px = d[1] * e2z - d[2] * e2y
    py = d[2] * e2x - d[0] * e2z
    pz = d[0] * e2y - d[1] * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = np.abs(det) > np.float32(1e-10)
    inv = np.where(ok, np.float32(1.0) / np.where(ok, det, np.float32(1.0)),
                   np.float32(0.0))
    tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= np.float32(1.0))
           & (t > t_min) & (t < t_upper))
    return hit, t, u, v


def _np_walk(slabs, bounds, meta, o, d, t_min, t_max):
    """One ray's closest hit by a recursive near-first BVH2 walk: a node
    whose entry is no longer below the best t is pruned, an interior
    node's two children are tested against the best t and the near one
    (the left on equal entries) is walked first, a leaf's 128 lanes are
    tested with a strict t < best (the lowest lane among equal t) ->
    the (8,) row t | tri | u | v | 0 0 | interior nodes expanded | leaves
    tested."""
    inv = np.where(np.abs(d) > np.float32(1e-12),
                   np.float32(1.0) / np.where(d == 0, np.float32(1.0), d),
                   np.float32(1e30)).astype(np.float32)
    st = {"t": t_max, "tri": -1, "u": np.float32(0), "v": np.float32(0),
          "nodes": 0, "leaves": 0}

    def test(i):
        enter, exit_ = _np_slab(o, inv, bounds[i, 0:3], bounds[i, 3:6])
        return enter <= exit_ and enter < st["t"], enter

    def visit(i, enter):
        if enter >= st["t"]:
            return
        c = meta[i, 2]
        if c >= 0:
            st["leaves"] += 1
            hit, t, u, v = _np_moller(slabs[c, 0:9], o, d, t_min, st["t"])
            if hit.any():
                t = np.where(hit, t, np.float32(np.inf))
                j = int(np.argmin(t))  # the first lane at the minimum
                st.update(t=t[j], tri=int(c) * 128 + j, u=u[j], v=v[j])
            return
        st["nodes"] += 1
        left, right = meta[i, 0], meta[i, 1]
        kids = [(*test(left), left), (*test(right), right)]
        if kids[0][1] > kids[1][1]:  # the near child first, left on ties
            kids.reverse()
        for ok, enter_c, child in kids:
            if ok:
                visit(child, enter_c)

    if t_max > 0:
        ok, enter = test(0)
        if ok:
            visit(0, enter)
    return np.array([st["t"], st["tri"], st["u"], st["v"], 0, 0, st["nodes"],
                     st["leaves"]], np.float32)


@pytest.mark.parametrize("n_clusters,seed", [(16, 0), (48, 1)])
def test_visits_plain_counts_equal_a_recursive_walk(n_clusters, seed):
    """The lockstep plain walk's rows, counts included, equal a numpy
    recursive walk's ray by ray, bit for bit, on a small plate scene:
    the count contract X3a (K2's warp walk with per-ray counts) keeps.
    Rays from random points of the scene's bounds in random directions,
    a bundle from outside the grid along its diagonal, t_max 0, finite
    and inf lanes."""
    _, (sc, _, _) = entry("cpu", scene="plate", n_clusters=n_clusters,
                          width=16, height=16)
    slabs = sc["geom"]["packed9"]
    bounds, meta = sc["frame"]["bvh_bounds"], sc["frame"]["bvh_meta"]
    lo = sc["frame"]["wc_aabb_min_w"].amin(0).numpy()
    hi = sc["frame"]["wc_aabb_max_w"].amax(0).numpy()
    R = 160
    rng = np.random.default_rng(seed)
    o = (lo + (hi - lo) * rng.random((R, 3))).astype(np.float32)
    d = rng.normal(size=(R, 3))
    o[:40] = lo - 1.0
    d[:40] = (hi - lo) / np.linalg.norm(hi - lo) + 0.05 * d[:40]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::13, 2] = 0.0
    t_max = np.full(R, np.inf, np.float32)
    t_max[::9] = 0.0
    t_max[1::7] = 3.0
    got = tb.trace_closest_bvh_visits_plain(
        slabs, bounds, meta, _t(o), _t(d), T_CLOSEST, _t(t_max)).numpy()
    s, b, m = slabs.numpy(), bounds.numpy(), meta.numpy()
    want = np.stack([_np_walk(s, b, m, o[r], d[r], np.float32(T_CLOSEST),
                              t_max[r]) for r in range(R)])
    np.testing.assert_array_equal(got, want)
    assert want[:, 7].max() > 1 and want[:, 6].max() > 2
    assert (want[:, 1] >= 0).sum() > 20
