"""The 8-wide BVH path of prosper_tpu_torch against prosper_tpu:
`accel.bvh.pack_nodes8` and the plain PyTorch versions of K11-K13
(`trace_bvh.trace_closest_bvh8`, `trace_closest_bvh8_full`,
`trace_any_bvh8`) against the Pallas kernels they replace, run in
interpret mode on the CPU, against brute force and against the plain
versions of K2, K4 and K3 on the same rays. Sizes are those of
tests/test_trace_bvh8.py.

Tolerances: the 8-wide table is equal bit for bit, NaN slots included;
hit/miss, tri and occlusion are equal; t within rtol 1e-5 (atol 1e-6)
against Pallas and brute force, whose Möller arithmetic differs in
order; the full rows within 1e-5 of Pallas's and equal to K4's plain
version (the same brute force and interpolation). On the tie scene
(testing.make_tie_scene, testing.tie_nodes8) the plain versions keep the
brute-force (t, tri) minimum exactly, and the Pallas kernels another copy
at the same t: t, u, v equal, tri an exact tie.

The Pallas kernels discard t_min and hard-code 1e-4 (closest) and 0.1
(any); the port honours it, so these tests pass those values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.accel import bvh as jbvh
from prosper_tpu.ops import trace, trace_pallas
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.ops.trace_pallas_full import pack_tris_full
from prosper_tpu.testing import make_test_scene
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.accel import bvh as tbvh
from prosper_tpu_torch.ops import trace_bvh as tb
from tests.test_trace import _brute_force, _random_scene
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
T_CLOSEST, T_ANY = 1e-4, 0.1


def _t(a):
    return torch.as_tensor(np.array(a))


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    return c - e, c + e


@pytest.mark.parametrize("n", [1, 6, 37])
def test_pack_nodes8_equals_jax(n):
    """Bit for bit, NaN empty slots included; transform_aabbs too."""
    lo, hi = _boxes(n, n)
    got = tbvh.pack_nodes8(tbvh.build_bvh(lo, hi, max_leaf_size=1))
    want = jbvh.pack_nodes8(jbvh.build_bvh(lo, hi, max_leaf_size=1))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32
    # every cluster in exactly one leaf slot; the stack bound holds
    enc = got[..., 6]
    assert sorted((-enc[enc < 0] - 1).astype(int).tolist()) == list(range(n))
    assert 7 * tbvh.nodes8_depth(got) + 1 <= tb.STACK8_CAP
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[0.0, -2.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.5]]
    m[:3, 3] = [1.0, -2.0, 3.0]
    for g, w in zip(tbvh.transform_aabbs(lo, hi, m),
                    jbvh.transform_aabbs(lo, hi, m)):
        np.testing.assert_array_equal(g, w)


def _rays(R, seed, center=None):
    rng = np.random.default_rng(seed)
    if center is None:
        o = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    else:
        o = (center + rng.uniform(-0.3, 0.3, (R, 3))).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _case(n_clusters, seed):
    tris, wc_min, wc_max = _random_scene(n_clusters=n_clusters, seed=seed)
    packed = trace_pallas.pack_tris(tris)
    bvh = jbvh.build_bvh(np.asarray(wc_min), np.asarray(wc_max),
                         max_leaf_size=1)
    nodes8 = tbvh.pack_nodes8(tbvh.build_bvh(
        np.asarray(wc_min), np.asarray(wc_max), max_leaf_size=1))
    bounds, meta = jbvh.pack_nodes(bvh)
    return tris, packed, nodes8, bounds, meta


def _rows_equal(rows, t, tri, rtol=1e-5, atol=1e-6):
    """(R, 8) plain rows against a reference (t, tri): hit/miss and tri
    equal, t within tolerance where both hit."""
    rows = rows.numpy()
    tri = np.asarray(tri)
    np.testing.assert_array_equal(rows[:, 1] >= 0, tri >= 0)
    np.testing.assert_array_equal(rows[:, 1].astype(np.int64), tri)
    hit = tri >= 0
    np.testing.assert_allclose(rows[hit, 0], np.asarray(t)[hit], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 7])
def test_closest8_plain_matches_pallas_brute_and_k2(seed):
    """K11: plain = Pallas K11 (interpret) = brute force = K2's plain."""
    tris, packed, nodes8, bounds, meta = _case(6, seed)
    o, d = _rays(trace.TILE * 2, seed + 1)
    with interpret_mode():
        want = jtb.trace_closest_bvh8(packed, jnp.asarray(nodes8),
                                      jnp.asarray(o), jnp.asarray(d),
                                      T_CLOSEST, np.inf)
    slabs = _t(packed)
    got = tb.trace_closest_bvh8(slabs, _t(nodes8), _t(o), _t(d), T_CLOSEST,
                                np.inf)
    _rows_equal(got, want["t"], want["tri"])
    np.testing.assert_array_equal(got[:, 0].numpy()[np.asarray(want["tri"]) < 0],
                                  np.inf)
    b_tri, b_t = _brute_force(tris, o, d, T_CLOSEST, np.inf)
    _rows_equal(got, b_t, b_tri)
    k2 = tb.trace_closest_bvh(slabs, _t(bounds), _t(meta), _t(o), _t(d),
                              T_CLOSEST, np.inf)
    torch.testing.assert_close(got, k2, rtol=0, atol=0)


def test_closest8_finite_tmax_and_dead_rays():
    """Per-ray t_max, half the rays dead (t_max 0): a miss keeps t_max."""
    tris, packed, nodes8, _, _ = _case(4, 2)
    R = trace.TILE * 2
    o, d = _rays(R, 3)
    t_max = np.full((R,), 6.0, np.float32)
    t_max[trace.TILE:] = 0.0
    with interpret_mode():
        want = jtb.trace_closest_bvh8(packed, jnp.asarray(nodes8),
                                      jnp.asarray(o), jnp.asarray(d),
                                      T_CLOSEST, jnp.asarray(t_max))
    got = tb.trace_closest_bvh8(_t(packed), _t(nodes8), _t(o), _t(d),
                                T_CLOSEST, _t(t_max))
    _rows_equal(got, want["t"], want["tri"])
    miss = got[:, 1].numpy() < 0
    np.testing.assert_array_equal(got[:, 0].numpy()[miss], t_max[miss])
    assert miss[trace.TILE:].all()
    b_tri, _ = _brute_force(tris, o, d, T_CLOSEST, 6.0)
    np.testing.assert_array_equal(got[: trace.TILE, 1].numpy(),
                                  b_tri[: trace.TILE])


@pytest.mark.parametrize("t_max", [6.0, np.inf])
def test_any8_plain_matches_pallas_brute_and_k3(t_max):
    """K13: plain = Pallas K13 (interpret) = brute force = K3's plain."""
    tris, packed, nodes8, bounds, meta = _case(5, 3)
    o, d = _rays(trace.TILE, 4)
    with interpret_mode():
        want = jtb.trace_any_bvh8(packed, jnp.asarray(nodes8), jnp.asarray(o),
                                  jnp.asarray(d), T_ANY, t_max)
    slabs = _t(packed)
    got = tb.trace_any_bvh8(slabs, _t(nodes8), _t(o), _t(d), T_ANY, t_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b_tri, _ = _brute_force(tris, o, d, T_ANY, t_max)
    np.testing.assert_array_equal(got.numpy(), b_tri >= 0)
    k3 = tb.trace_any_bvh(slabs, _t(bounds), _t(meta), _t(o), _t(d), T_ANY,
                          t_max)
    np.testing.assert_array_equal(got.numpy(), k3.numpy())
    assert 0 < int(got.sum()) < got.shape[0]


def test_closest8_full_plain_matches_pallas_and_k4():
    """K12 on make_test_scene's f32 slabs: the full rows within 1e-5 of
    Pallas K12 (interpret), equal to K4's plain version."""
    static, frame, _, _ = make_test_scene(n_boxes=4)
    packed_full = np.asarray(pack_tris_full(
        {k: jnp.asarray(v) for k, v in static.items() if k != "materials"},
        {k: jnp.asarray(v) for k, v in frame.items() if k != "lights"},
        dtype=jnp.float32))
    wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    nodes8 = tbvh.pack_nodes8(tbvh.build_bvh(wc_min, wc_max, max_leaf_size=1))
    bounds, meta = tbvh.pack_nodes(tbvh.build_bvh(wc_min, wc_max,
                                                  max_leaf_size=1))
    rng = np.random.default_rng(11)
    R = trace.TILE
    o = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    o[:, 1] += 1.0
    d = rng.uniform(-1, 1, (R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with interpret_mode():
        want = jtb.trace_closest_bvh8_full(
            jnp.asarray(packed_full), jnp.asarray(nodes8), jnp.asarray(o),
            jnp.asarray(d), T_CLOSEST, np.inf, packed=True)
    slabs = _t(packed_full)
    got = tb.trace_closest_bvh8_full(slabs, _t(nodes8), _t(o), _t(d),
                                     T_CLOSEST, np.inf)
    want = np.asarray(want)
    hit = want[:, 1] >= 0
    assert hit.sum() > R // 8
    np.testing.assert_array_equal(got[:, 1].numpy(), want[:, 1])
    np.testing.assert_allclose(got.numpy()[hit], want[hit], rtol=1e-5,
                               atol=1e-5)
    k4 = tb.trace_closest_bvh_full(slabs, _t(bounds), _t(meta), _t(o), _t(d),
                                   T_CLOSEST, np.inf)
    torch.testing.assert_close(got, k4, rtol=0, atol=0)


def empty_slot_case():
    """Six clusters (the root holds six leaves and two empty slots) and
    rays that start inside the root's box, near the scene's centre, in
    every direction. Shared with the card test of K11-K13."""
    tris, packed, nodes8, bounds, meta = _case(6, 0)
    center = (np.asarray(tris["v0"])[: 6 * 128:128]).mean(0)
    o, d = _rays(trace.TILE, 9, center=center)
    return tris, packed, nodes8, bounds, meta, o, d


def test_empty_slots_and_rays_inside_the_root():
    """Empty slots (NaN bounds, enc 0 = the root) lie in the root node,
    and a min/max that drops NaN (torch.fmin/fmax, CUDA's fminf/fmaxf)
    gives them entry 0, as a box the ray starts inside: a slab test that
    clamps its exit to t_max then enters them and re-enters the root.
    The plain versions and the Pallas kernels agree with brute force on
    rays from inside the root box."""
    tris, packed, nodes8, bounds, meta, o, d = empty_slot_case()
    root = torch.as_tensor(nodes8[0])
    empty = torch.isnan(root[:, 0])
    assert int(empty.sum()) == 2 and (root[empty, 6] == 0).all()
    # the hazard: NaN-dropping entries of 0 and exits clamped to t_max
    ot, inv = _t(o)[:, None], 1.0 / _t(d)[:, None]
    t0 = (root[None, :, 0:3] - ot) * inv
    t1 = (root[None, :, 3:6] - ot) * inv
    zero, t_max = torch.tensor(0.0), torch.tensor(1e30)
    en = torch.fmax(torch.fmax(torch.fmin(t0, t1)[..., 0],
                               torch.fmin(t0, t1)[..., 1]),
                    torch.fmax(torch.fmin(t0, t1)[..., 2], zero))
    ex = torch.fmin(torch.fmin(torch.fmax(t0, t1).amin(-1), t_max), t_max)
    assert bool((en == 0)[:, empty].all() and (en <= ex)[:, empty].all())
    # rays start inside the root's box
    lo = nodes8[0, ~empty.numpy(), 0:3].min(0)
    hi = nodes8[0, ~empty.numpy(), 3:6].max(0)
    assert ((o > lo) & (o < hi)).all()

    slabs, n8 = _t(packed), _t(nodes8)
    with interpret_mode():
        want = jtb.trace_closest_bvh8(packed, jnp.asarray(nodes8),
                                      jnp.asarray(o), jnp.asarray(d),
                                      T_CLOSEST, np.inf)
        want_any = jtb.trace_any_bvh8(packed, jnp.asarray(nodes8),
                                      jnp.asarray(o), jnp.asarray(d), T_ANY,
                                      np.inf)
    got = tb.trace_closest_bvh8(slabs, n8, _t(o), _t(d), T_CLOSEST, np.inf)
    _rows_equal(got, want["t"], want["tri"])
    b_tri, b_t = _brute_force(tris, o, d, T_CLOSEST, np.inf)
    _rows_equal(got, b_t, b_tri)
    assert (b_tri >= 0).sum() > trace.TILE // 4
    occ = tb.trace_any_bvh8(slabs, n8, _t(o), _t(d), T_ANY, np.inf)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_any))
    np.testing.assert_array_equal(
        occ.numpy(), _brute_force(tris, o, d, T_ANY, np.inf)[0] >= 0)


def test_nodes8_leaf_boxes_are_the_bvh2_leaf_boxes():
    """The plain versions' cluster boxes equal K2's (the BVH2 leaves)."""
    _, packed, nodes8, bounds, meta = _case(37, 1)
    C = packed.shape[0]
    got = tb.nodes8_leaf_boxes(_t(nodes8), C)
    want = tb._leaf_boxes(_t(bounds), _t(meta), C)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("t_max", [np.inf, 5.0])
def test_closest8_plain_takes_the_lowest_copy_on_ties(t_max):
    """testing.make_tie_scene under testing.tie_nodes8 (one root, the two
    leaf boxes in its slots), attribute rows from rows=40: every ray
    meets every copy of one triangle at t = 5. K11's and K12's plain
    versions (what their kernels equal bit for bit on the card) keep the
    brute-force minimum of (t, tri), tri 9, on every ray, with tri 9's
    attributes; at t_max = 5 every ray misses (a hit needs t < t_max).
    The Pallas K11 and K12 in interpret mode pop the nearest slot first
    and keep the copy they meet first at t = 5, 168 (cluster 1's lowest)
    on every ray: hit, t, u and v equal, tri an exact tie, and K12's
    attributes those of tri 168."""
    slabs, bounds, meta, o, d, _ = ttesting.make_tie_scene(64, rows=40)
    nodes8 = ttesting.tie_nodes8(bounds, meta)
    assert np.isnan(nodes8[0, 2:, 0:6]).all() and (nodes8[0, 2:, 6] == 0).all()
    R = o.shape[0]
    tris = {k: slabs[:, 3 * i:3 * i + 3].transpose(0, 2, 1).reshape(-1, 3)
            for i, k in enumerate(("v0", "e1", "e2"))}
    b_tri, b_t = _brute_force(tris, o, d, T_CLOSEST, t_max)
    hit = t_max > 5.0
    np.testing.assert_array_equal(b_tri, 9 if hit else -1)

    args = (_t(slabs), _t(nodes8), _t(o), _t(d), T_CLOSEST,
            _t(np.full(R, t_max, np.float32)))
    got = tb.trace_closest_bvh8(*args)
    full = tb.trace_closest_bvh8_full(*args)
    np.testing.assert_array_equal(got[:, 1].numpy(), b_tri)
    np.testing.assert_array_equal(got[:, 0].numpy(), 5.0 if hit else t_max)
    torch.testing.assert_close(full[:, 0:2], got[:, 0:2], rtol=0, atol=0)
    torch.testing.assert_close(full, tb._full_rows(_t(slabs), got), rtol=0,
                               atol=0)
    with interpret_mode():
        want = jtb.trace_closest_bvh8(
            jnp.asarray(slabs[:, 0:9]), jnp.asarray(nodes8), jnp.asarray(o),
            jnp.asarray(d), T_CLOSEST, t_max)
        want_full = np.asarray(jtb.trace_closest_bvh8_full(
            jnp.asarray(slabs), jnp.asarray(nodes8), jnp.asarray(o),
            jnp.asarray(d), T_CLOSEST, t_max, packed=True))
    np.testing.assert_array_equal(np.asarray(want["tri"]),
                                  168 if hit else -1)
    np.testing.assert_array_equal(want_full[:, 1], 168 if hit else -1)
    if not hit:
        return
    for col, key in ((0, "t"), (2, "u"), (3, "v")):
        np.testing.assert_array_equal(got[:, col].numpy(),
                                      np.asarray(want[key]))
    other = got.clone()
    other[:, 1] = 168.0
    np.testing.assert_allclose(want_full, tb._full_rows(_t(slabs), other),
                               rtol=1e-5, atol=1e-5)
