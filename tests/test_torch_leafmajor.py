"""The leaf-major tracer of prosper_tpu_torch (ops/trace_leafmajor.py, K14
`run_pairs` as its plain version on the CPU), the dense closest hit K9
(`trace_bvh.trace_closest_bvh_dense`, plain), the incoherent-ray policy
(ops/trace.make_bounce_tracer) and the path tracer and ReSTIR frames
under config.policy.bounce_tracer = "leafmajor", against prosper_tpu on
the same numpy inputs. Where the JAX code reaches a Pallas kernel it
runs in interpret mode on the CPU (tests/test_trace_leafmajor.py).

Scenes: `_random_scene` (6 clusters, no heavy ray); the overlapping
scene of test_trace_leafmajor.py, whose rays all have more than
PAIR_CAP_PER_RAY candidates (heavy rays on K2/K3); the plate scene of
160 clusters with random rays, whose tiles overflow VIS_CAP (every ray
of such a tile heavy), and one coherent tile that does not.

Tolerances:
- the culls, candidate lists, pairs and blocks: exact (the same float32
  operations; booleans and ids);
- K14's plain version against the Pallas kernel: tri and occlusion
  exact, t within rtol 1e-5 / atol 1e-6, u and v within 1e-5 where hit;
- the hybrids against the JAX `_safe` tracers: tri and occlusion exact,
  t within rtol 1e-5 / atol 1e-6, attributes within 1e-5 (the
  barycentric blend of the same rows in another fusion), u within 1e-4
  (see test_hybrid_matches_jax_safe). The Pallas
  packet kernels hard-code t_min 1e-4 (closest) and 0.1 (any), the port
  honours the argument, so the tests pass those values;
- K9's plain version against the Pallas kernel (t_min 1e-4): hit/miss
  equal, tri equal except exact t ties, t within rtol 1e-5 / atol 1e-6;
- the path-traced frame against the Pallas path: rtol 2e-4 / atol 2e-5
  and equal ray counts (test_trace_leafmajor.py's rule);
- the ReSTIR frames against the JAX CPU frames: at most 0.5% of pixels
  off by more than 1e-3 + 1e-3 relative (test_torch_restir.py's rule).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu import config as jconfig
from prosper_tpu.accel.bvh import build_bvh, pack_nodes
from prosper_tpu.ops import trace_bvh as jtrace_bvh
from prosper_tpu.ops import trace_leafmajor as J
from prosper_tpu.ops import trace_pallas
from prosper_tpu.ops.intersect import packet_aabb_overlap_2d as j_overlap_2d
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render import pt as jpt
from prosper_tpu.render import restir as jrestir
from prosper_tpu_torch import config
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import slabs as tslabs
from prosper_tpu_torch.ops import trace as ttrace
from prosper_tpu_torch.ops import trace_bvh
from prosper_tpu_torch.ops import trace_leafmajor as T
from prosper_tpu_torch.ops.intersect import packet_aabb_overlap_2d
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import pt, restir
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene
from tests.test_trace import _random_scene
from tests.test_trace_leafmajor import _overlapping_scene, _rays, interpret_mode

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _bvh(wc_min, wc_max):
    return pack_nodes(build_bvh(np.asarray(wc_min), np.asarray(wc_max),
                                max_leaf_size=1))


def _scene(kind):
    """numpy (packed9, bounds, meta, wc_min, wc_max, o, d, t_max): t_max
    a scalar for "random", per ray with disabled (0) and finite lanes for
    the others."""
    if kind == "plate":
        static, frame, arena, _ = ttesting.make_plate_scene(160, 0)
        packed = from_numpy_scene(static, frame, arena,
                                  "cpu")["geom"]["packed9"].numpy()
        wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
        bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]
        rng = np.random.default_rng(3)
        lo, hi = wc_min.min(0), wc_max.max(0)
        R = 700
        o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
        d = rng.normal(size=(R, 3)).astype(np.float32)
        # tile 0: one origin outside the grid, a narrow cone across it
        axis = (hi - lo) / np.linalg.norm(hi - lo)
        o[:256] = lo - 1.0
        d[:256] = axis + 0.02 * rng.normal(size=(256, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_max = np.full(R, np.inf, np.float32)
        t_max[::9] = 0.0
        t_max[1::7] = 6.0
        return packed, bounds, meta, wc_min, wc_max, o, d, t_max
    if kind == "overlap":
        tris, wc_min, wc_max = _overlapping_scene()
        o, _ = _rays(11, 512)
        target = np.asarray((wc_min.min(0) + wc_max.max(0)) / 2.0)
        d = target[None] - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        t_max = np.full(512, np.inf, np.float32)
        t_max[::7] = 0.0
        t_max[1::5] = 4.0
    else:
        tris, wc_min, wc_max = _random_scene(n_clusters=6, seed=0)
        o, d = _rays(1, 700)
        t_max = np.inf
    bounds, meta = _bvh(wc_min, wc_max)
    packed = np.asarray(trace_pallas.pack_tris(tris))
    return (packed, bounds, meta, np.asarray(wc_min), np.asarray(wc_max), o,
            d, t_max)


def test_packet_overlap_2d_matches_jax():
    """Packets with uniform and zero-spanning direction intervals against
    boxes, two of them inverted: exact."""
    rng = np.random.default_rng(0)
    P, A = 40, 50
    o_lo = rng.uniform(-5, 5, (P, 3)).astype(np.float32)
    o_hi = o_lo + rng.uniform(0, 2, (P, 3)).astype(np.float32)
    d_lo = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    d_hi = d_lo + rng.uniform(0, 0.6, (P, 3)).astype(np.float32)
    bmin = rng.uniform(-8, 8, (A, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 3, (A, 3)).astype(np.float32)
    bmin[3], bmax[3] = bmax[3], bmin[3].copy()
    bmin[7, 1] = bmax[7, 1] + 1.0
    t_max = rng.uniform(0, 20, P).astype(np.float32)
    t_max[::5] = np.inf
    args = (o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_max)
    want = np.asarray(j_overlap_2d(*(_j(a) for a in args)))
    got = packet_aabb_overlap_2d(*(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size and not want[:, [3, 7]].any()


@pytest.mark.parametrize("kind", ["random", "overlap", "plate"])
def test_candidate_lists_pairs_and_blocks_match_jax(kind):
    """ray_leaf, heavy, tile_overflow; the pairs; block_leaf, slot_ray,
    slot_valid: exact. The plate scene overflows VIS_CAP in some tiles
    and not in its coherent one."""
    _, _, _, wc_min, wc_max, o, d, t_max = _scene(kind)
    want = J.candidate_lists(_j(wc_min), _j(wc_max), _j(o), _j(d), 1e-4,
                             _j(t_max))
    got = T.candidate_lists(_t(wc_min), _t(wc_max), _t(o), _t(d), 1e-4,
                            _t(t_max))
    for g, w, name in zip(got, want, ("ray_leaf", "heavy", "tile_overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    heavy = got[1].numpy()
    assert bool(got[2]) == (kind == "plate")
    if kind == "plate":
        assert not heavy[:256].all() and heavy[256:].all()
    else:
        assert heavy.any() == (kind == "overlap")
    C = wc_min.shape[0]
    want_p = J.pairs_from_lists(want[0], C)
    got_p = T.pairs_from_lists(got[0], C)
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_b = J.build_blocks(*want_p, C)
    got_b = T.build_blocks(*got_p, C)
    for g, w, name in zip(got_b, want_b, ("block_leaf", "slot_ray",
                                          "slot_valid", "pair_block",
                                          "pair_slot")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got_b[0] >= 0).any()


def test_enumerate_pairs_matches_jax():
    """The dense enumeration (leaf-major, no sort) and its overflow flag:
    exact, with and without overflow."""
    for kind in ("random", "overlap"):
        _, _, _, wc_min, wc_max, o, d, t_max = _scene(kind)
        want = J.enumerate_pairs(_j(wc_min), _j(wc_max), _j(o), _j(d), 1e-4,
                                 _j(t_max))
        got = T.enumerate_pairs(_t(wc_min), _t(wc_max), _t(o), _t(d), 1e-4,
                                _t(t_max))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool(got[3]) == (kind == "overlap")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_run_pairs_plain_matches_pallas(any_hit):
    """K14's plain version against `_run_pairs` in interpret mode on the
    same blocks (the random scene's, t_max 6)."""
    packed, _, _, wc_min, wc_max, o, d, _ = _scene("random")
    C = wc_min.shape[0]
    t_min, t_max = 1e-4, 6.0
    jb = J.build_blocks(*J.pairs_from_lists(J.candidate_lists(
        _j(wc_min), _j(wc_max), _j(o), _j(d), t_min, t_max)[0], C), C)
    cols = J._pack_cols(_j(o), _j(d), t_min, t_max, jb[1], jb[2])
    with interpret_mode():
        want = np.asarray(J._run_pairs(_j(packed), jb[0], cols, any_hit))
    block_leaf, slot_ray, slot_valid = (_t(a) for a in jb[:3])
    got = T.run_pairs_plain(_t(packed), block_leaf, slot_ray, slot_valid,
                            _t(o), _t(d), t_min, t_max, any_hit).numpy()
    valid = slot_valid.numpy()
    if any_hit:
        np.testing.assert_array_equal(got & valid, (want[:, 0] > 0) & valid)
        assert (got & valid).any()
    else:
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5,
                                   atol=1e-6)
        hit = got[:, 1] >= 0
        np.testing.assert_allclose(got[:, 2:][np.repeat(hit[:, None], 2, 1)],
                                   want[:, 2:][np.repeat(hit[:, None], 2, 1)],
                                   rtol=1e-5, atol=1e-5)
        assert hit.any()
    assert T.run_pairs.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("layout", [*ttesting.PAIR_LAYOUTS, "ties"])
def test_run_pairs_layouts_match_pallas(layout, any_hit):
    """K14's plain version (what run_pairs runs on the CPU) against
    `_run_pairs` in interpret mode on every slot of 40 blocks (any hit:
    every slot of the live blocks, and 0 on the empty ones) laid out by
    testing.make_pair_layout (all empty; live at the front; live between
    and after empty blocks; partly valid slots), t_max per ray with
    zeros and finite values, on the random scene; "ties": the front
    layout on make_tie_scene, every ray meeting every copy of its leaf's
    triangle at one t, where the lowest copy wins."""
    if layout == "ties":
        packed, _, _, o, d, _ = ttesting.make_tie_scene(64)
        kind = "front"
    else:
        packed, _, _, _, _, o, d, _ = _scene("random")
        kind = layout
    C, R = packed.shape[0], o.shape[0]
    block_leaf, slot_ray, slot_valid = ttesting.make_pair_layout(
        kind, 40, C, R, seed=len(layout))
    t_max = np.full(R, np.inf, np.float32)
    t_max[::9] = 0.0
    t_max[1::7] = 3.0
    t_min = 1e-4
    cols = J._pack_cols(_j(o), _j(d), t_min, _j(t_max), _j(slot_ray),
                        _j(slot_valid))
    with interpret_mode():
        want = np.asarray(J._run_pairs(_j(packed), _j(block_leaf), cols,
                                       any_hit))
    got = T.run_pairs(_t(packed), _t(block_leaf), _t(slot_ray),
                      _t(slot_valid), _t(o), _t(d), t_min, _t(t_max),
                      any_hit).numpy()
    assert T.run_pairs.launches == 0  # CPU: the plain version
    if any_hit:
        # the Pallas kernel writes an empty block's closest-hit miss rows
        # (t 3e38 in row 0) in its any form too; the port writes 0
        live = (block_leaf >= 0)[:, None]
        np.testing.assert_array_equal(got, (want[:, 0] > 0) & live)
        assert got.any() == (layout != "empty")
        return
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-6)
    hit = got[:, 1] >= 0
    for row in (2, 3):
        np.testing.assert_allclose(got[:, row][hit], want[:, row][hit],
                                   rtol=1e-5, atol=1e-5)
        assert (got[:, row][~hit] == 0).all()
    assert (got[:, 0][~hit] == 3e38).all()
    assert hit.any() == (layout != "empty")
    if layout == "ties":
        # the lowest copy: lane 9 of cluster 0, lane 40 of cluster 1
        lowest = np.where(block_leaf == 0, 9, 128 + 40)[:, None]
        np.testing.assert_array_equal(
            got[:, 1][hit], np.broadcast_to(lowest, hit.shape)[hit])
        assert hit.sum() > 100


@pytest.mark.parametrize("kind", ["random", "overlap", "plate"])
def test_hybrid_matches_jax_safe(kind):
    """trace_closest_leafmajor_safe and trace_any_leafmajor_safe against
    JAX's (K14 and K2/K3 in interpret mode); on the random scene the
    full form, with 40-row slabs of random attributes."""
    packed, bounds, meta, wc_min, wc_max, o, d, t_max = _scene(kind)
    full = kind == "random"
    if full:
        slabs = np.zeros((packed.shape[0], 40, 128), np.float32)
        slabs[:, :9] = packed
        slabs[:, 9:38] = np.random.default_rng(12).random(
            (packed.shape[0], 29, 128), dtype=np.float32)
        slabs[:, 36] = np.floor(slabs[:, 36] * 4)  # material ids
    else:
        slabs = packed
    scene = (slabs, bounds, meta, wc_min, wc_max, o, d)
    jclosest = (J.trace_closest_leafmajor_full_safe if full
                else J.trace_closest_leafmajor_safe)
    with interpret_mode():
        want = jclosest(*(_j(a) for a in scene), 1e-4, _j(t_max))
        want_occ = np.asarray(J.trace_any_leafmajor_safe(
            *(_j(a) for a in scene), 0.1, _j(t_max)))
    tclosest = (T.trace_closest_leafmajor_full_safe if full
                else T.trace_closest_leafmajor_safe)
    got = tclosest(*(_t(a) for a in scene), 1e-4, _t(t_max))
    got_occ = T.trace_any_leafmajor_safe(*(_t(a) for a in scene), 0.1,
                                         _t(t_max)).numpy()
    tri = np.asarray(want["tri"])
    np.testing.assert_array_equal(got["tri"].numpy(), tri)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_occ, want_occ)
    assert 0 < (tri >= 0).sum() < tri.size and 0 < got_occ.sum()
    if full:
        for k in ("normal", "tangent", "uv", "tri_lod"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got["material"].numpy(),
                                      np.asarray(want["material"]))
        # attrs_from_hit gives the set of slabs.attrs_from_hit_rows
        hit = T.trace_closest_leafmajor_safe(*(_t(a) for a in scene), 1e-4,
                                             _t(t_max))
        rows = tslabs.attrs_from_hit_rows(
            tslabs.attr_rows_from_packed(_t(slabs)), hit)
        for k, v in T.attrs_from_hit(_t(slabs), hit).items():
            np.testing.assert_allclose(v.numpy(), rows[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    else:
        # u of the same triangle: XLA may contract the Möller sums into
        # fused multiply-adds, PyTorch's CPU kernels do not; on the plate
        # scene's larger coordinates that moves u by up to 1.5e-5
        np.testing.assert_allclose(got["u"].numpy()[tri >= 0],
                                   np.asarray(want["u"])[tri >= 0],
                                   rtol=1e-5, atol=1e-4)


def test_nonhybrid_tracers_and_overflow_match_jax():
    """trace_closest_leafmajor / trace_any_leafmajor: without overflow
    equal to the hybrid; with it the JAX flag and the same (truncated)
    result."""
    for kind in ("random", "overlap"):
        packed, _, _, wc_min, wc_max, o, d, t_max = _scene(kind)
        args = (packed, wc_min, wc_max, o, d)
        with interpret_mode():
            want = J.trace_closest_leafmajor(*(_j(a) for a in args), 1e-4,
                                             _j(t_max))
            want_occ, want_ovf = J.trace_any_leafmajor(
                *(_j(a) for a in args), 0.1, _j(t_max))
        got = T.trace_closest_leafmajor(*(_t(a) for a in args), 1e-4,
                                        _t(t_max))
        got_occ, got_ovf = T.trace_any_leafmajor(*(_t(a) for a in args),
                                                 0.1, _t(t_max))
        assert bool(got["_overflow"]) == bool(want["_overflow"]) == (
            kind == "overlap") == bool(got_ovf) == bool(want_ovf)
        np.testing.assert_array_equal(got["tri"].numpy(),
                                      np.asarray(want["tri"]))
        np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got_occ.numpy(), np.asarray(want_occ))


def _plate64():
    static, frame, arena, _ = ttesting.make_plate_scene(64, 0)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(4)
    lo, hi = frame["wc_aabb_min_w"].min(0), frame["wc_aabb_max_w"].max(0)
    R = 700
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(R, np.inf, np.float32)
    t_max[::7] = 0.0
    t_max[1::9] = 3.0
    return scene, _t(o), _t(d), _t(t_max)


@pytest.mark.parametrize("skip", ["none", "mask", "all_true"])
def test_k9_plain_matches_pallas(skip):
    """K9's plain version against the Pallas `trace_closest_bvh_dense`
    in interpret mode (t_min 1e-4), and unmasked against K2's plain
    version; with a mask, no hit on a masked cluster."""
    scene, o, d, t_max = _plate64()
    frame = scene["frame"]
    args = (scene["geom"]["packed9"], frame["bvh_bounds"], frame["bvh_meta"])
    mask = {"none": None, "all_true": torch.ones(64, dtype=torch.bool),
            "mask": torch.as_tensor(np.random.default_rng(2).random(64)
                                    > 0.4)}[skip]
    got = trace_bvh.trace_closest_bvh_dense(*args, o, d, 1e-4, t_max,
                                            skip_mask=mask)
    with interpret_mode():
        want = jtrace_bvh.trace_closest_bvh_dense(
            *(_j(a) for a in args), _j(o), _j(d), 1e-4, _j(t_max),
            skip_mask=None if mask is None else _j(mask.to(torch.int32)))
    g_tri, w_tri = got[:, 1].numpy(), np.asarray(want["tri"])
    np.testing.assert_array_equal(g_tri >= 0, w_tri >= 0)
    both = g_tri >= 0
    g_t, w_t = got[:, 0].numpy(), np.asarray(want["t"])
    with np.errstate(invalid="ignore"):  # inf - inf on misses
        tie = np.abs(g_t - w_t) <= 1e-6 * np.abs(w_t)
    assert ((g_tri == w_tri) | tie)[both].all()
    np.testing.assert_allclose(g_t[both], w_t[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(g_t[~both], t_max.numpy()[~both])
    assert 0 < both.sum() < both.size
    if mask is None or skip == "all_true":
        k2 = trace_bvh.trace_closest_bvh_plain(*args, o, d, 1e-4, t_max)
        assert torch.equal(got, k2)
    else:
        assert mask[torch.as_tensor(g_tri[both]).long() // 128].all()
    assert trace_bvh.trace_closest_bvh_dense.launches == 0


@pytest.mark.parametrize("skip", ["none", "keep_both", "drop_0"])
def test_k9_plain_takes_the_lowest_copy_on_ties(skip):
    """testing.make_tie_scene: one triangle copied into several lanes of
    clusters 0 and 1, up and down rays alternating. K9's plain version
    (what its kernel equals bit for bit on the card) gives every ray the
    lowest copy over the live clusters: tri 9, or tri 168 when the skip
    mask drops cluster 0. The Pallas kernel in interpret mode pops the
    packet's nearest cluster first (cluster 1, entered at t = 1 by the up
    rays) and keeps its lowest copy, 168, at the same t: hit, t, u and v
    equal, tri an exact tie."""
    slabs, bounds, meta, o, d, _ = ttesting.make_tie_scene(64)
    mask = {"none": None, "keep_both": np.ones(2, bool),
            "drop_0": np.array([False, True])}[skip]
    t_max = np.full(64, np.inf, np.float32)
    got = trace_bvh.trace_closest_bvh_dense(
        *(_t(a) for a in (slabs, bounds, meta, o, d)), 1e-4, _t(t_max),
        skip_mask=None if mask is None else _t(mask))
    with interpret_mode():
        want = jtrace_bvh.trace_closest_bvh_dense(
            *(_j(a) for a in (slabs, bounds, meta, o, d)), 1e-4, _j(t_max),
            skip_mask=None if mask is None else _j(mask.astype(np.int32)))
    lowest = 168 if skip == "drop_0" else 9
    np.testing.assert_array_equal(got[:, 1].numpy(), lowest)
    np.testing.assert_array_equal(np.asarray(want["tri"]), 168)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want["t"]))
    np.testing.assert_array_equal(got[:, 0].numpy(), 5.0)
    for col, key in ((2, "u"), (3, "v")):
        np.testing.assert_array_equal(got[:, col].numpy(),
                                      np.asarray(want[key]))
    assert trace_bvh.trace_closest_bvh_dense.launches == 0


def test_bounce_policy(monkeypatch):
    """make_bounce_tracer: None under "packet", without BVH arrays and
    above LEAFMAJOR_MAX_CLUSTERS; the knob is read at each call; an
    unknown name raises; closest_full needs 38 slab rows; the tracers
    are the hybrids."""
    scene, o, d, t_max = _plate64()
    frame, geom = scene["frame"], scene["geom"]
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bvh = ttrace.frame_bvh(frame)
    assert config.policy.bounce_tracer == "packet"
    assert ttrace.make_bounce_tracer(geom["packed_full"], mn, mx, bvh) is None
    monkeypatch.setattr(config.policy, "bounce_tracer", "leafmajor")
    tr = ttrace.make_bounce_tracer(geom["packed_full"], mn, mx, bvh)
    assert tr["any"].func is T.trace_any_leafmajor_safe
    assert tr["closest_full"].func is T.trace_closest_leafmajor_full_safe
    assert ttrace.make_bounce_tracer(geom["packed9"], mn, mx,
                                     bvh)["closest_full"] is None
    assert ttrace.make_bounce_tracer(geom["packed_full"], mn, mx, None) is None
    big = torch.zeros((ttrace.LEAFMAJOR_MAX_CLUSTERS + 1, 3))
    assert ttrace.make_bounce_tracer(geom["packed9"], big, big, bvh) is None
    assert ttrace.make_bounce_tracer(geom["packed9"], mn, mx, bvh,
                                     prefer="packet") is None
    k3 = trace_bvh.trace_any_bvh(geom["packed9"], *bvh, o, d, 0.1, t_max)
    assert torch.equal(tr["any"](o, d, 0.1, t_max), k3)
    monkeypatch.setattr(config.policy, "bounce_tracer", "wide")
    with pytest.raises(ValueError, match="bounce_tracer"):
        ttrace.make_bounce_tracer(geom["packed9"], mn, mx, bvh)


def test_pt_frame_leafmajor_matches_jax_kernel_path(monkeypatch):
    """A 32x32, 2-bounce frame of make_test_scene under leafmajor against
    prosper_tpu.render.pt.pt_render_sample with leafmajor forced (the
    TPU path: jax.default_backend patched, Pallas in interpret mode).
    The port passes the Pallas kernels' primary t_min 1e-4."""
    static, frame, arena, cam_fn = ttesting.make_test_scene(4)
    W = H = 32
    cam = cam_fn(W, H)
    js, jf, ja = ({k: (
        {kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
        else jnp.asarray(v)) for k, v in tree.items()}
        for tree in (static, frame, arena))
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    jax.clear_caches()
    try:
        with interpret_mode(), mock.patch.object(
                jax, "default_backend", lambda: "tpu"), mock.patch.object(
                jconfig.policy, "bounce_tracer", "leafmajor"):
            want, want_n = jpt.pt_render_sample(js, jf, ja, jcam, W, H, 3,
                                                max_bounces=2,
                                                return_stats=True)
            want, want_n = np.asarray(want), int(want_n)
    finally:
        jax.clear_caches()
    monkeypatch.setattr(config.policy, "bounce_tracer", "leafmajor")
    monkeypatch.setattr(pt, "BOUNCE_T_MIN", 1e-4)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    calls = []
    real = ttrace.make_bounce_tracer
    monkeypatch.setattr(pt, "make_bounce_tracer",
                        lambda *a: calls.append(real(*a)) or calls[-1])
    got, got_n = pt.pt_render_sample(scene, cam, W, H, 3, 2,
                                     return_stats=True, device="cpu")
    assert calls and calls[0] is not None  # the frame took the hybrid
    assert int(got_n) == want_n
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["boxes", "plate"])
def test_restir_frames_leafmajor_match_jax(kind, monkeypatch):
    """restir_entry frames 0 and 1 under leafmajor (K14 and K3 plain)
    against the JAX CPU frames of the same scene."""
    make = {"boxes": lambda: ttesting.make_test_scene(4),
            "plate": lambda: ttesting.make_plate_scene(64, 0,
                                                       scatter_lights=16)}
    static, frame, arena, cam_fn = make[kind]()
    n = 32
    cam = cam_fn(n, n)
    js, jf, ja = ({k: (
        {kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
        else jnp.asarray(v)) for k, v in tree.items()}
        for tree in (static, frame, arena))
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    lut = pack_lut_quads(synthetic_lut())
    monkeypatch.setattr(config.policy, "bounce_tracer", "leafmajor")
    scene = from_numpy_scene(static, frame, arena, "cpu")
    tcam = camera_tensors(cam, "cpu")
    jstate = tstate = None
    for f in (0, 1):
        want, jstate = jrestir.restir_entry(
            static=js, frame=jf, arena=ja, cam=jcam, lut=jnp.asarray(lut),
            width=n, height=n, frame_index=f, state=jstate)
        got, tstate, n_shadow = restir.restir_entry(
            scene=scene, cam=tcam, lut=lut, width=n, height=n, device="cpu",
            frame_index=f, state=tstate, return_stats=True)
        want, got = np.asarray(want), got.numpy()
        off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
        assert off.mean() <= 5e-3, (f, off.sum())
        assert 0 < int(n_shadow) <= n * n
    assert T.run_pairs.launches == 0


def test_run_pairs_refuses_other_devices():
    z = torch.zeros((2, 9, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.run_pairs(z, torch.zeros(1, dtype=torch.int32, device="meta"),
                    torch.zeros((1, 256), dtype=torch.int32, device="meta"),
                    torch.zeros((1, 256), dtype=torch.bool, device="meta"),
                    torch.zeros((4, 3), device="meta"),
                    torch.zeros((4, 3), device="meta"), 0.1, 1.0, True)
