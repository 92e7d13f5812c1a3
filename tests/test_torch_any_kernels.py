"""The any-hit tracers of prosper_tpu_torch that ReSTIR and the path
tracer's shadow rays reach: K7 `trace_flat.trace_any_flat` and K10
`trace_bvh.trace_any_bvh_dense`, as their plain PyTorch versions, against
the Pallas kernels of prosper_tpu they replace (`trace_pallas.
trace_any_pallas`, `trace_bvh.trace_any_bvh_dense`) run in interpret
mode on the CPU, and against the port's K3 (`trace_any_bvh`, plain).

Inputs: the plate-64 scene with 16 scattered lights; 700 shadow-like
segments between random points of the scene's bounds (a short last
tile and packet), every seventh disabled with t_max = 0, and t_min 0.1,
which the Pallas any-hit kernels hard-code.

Tolerance: none. Occlusion is a boolean per ray and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import trace_bvh as jtrace_bvh
from prosper_tpu.ops import trace_pallas
from prosper_tpu.render.gbuffer import _masked_aabbs as j_masked_aabbs
from prosper_tpu_torch import config
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import trace as ttrace
from prosper_tpu_torch.ops import trace_bvh, trace_flat
from prosper_tpu_torch.render.gbuffer import _masked_aabbs
from prosper_tpu_torch.scene.convert import from_numpy_scene
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
R = 700
T_MIN = 0.1


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.fixture(scope="module")
def case():
    """(scene, o, d, t_max, cluster mask) on the CPU."""
    static, frame, arena, _ = ttesting.make_plate_scene(
        64, 0, scatter_lights=16)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(4)
    lo = frame["wc_aabb_min_w"].min(0)
    hi = frame["wc_aabb_max_w"].max(0)
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.uniform(lo, hi, (R, 3)).astype(np.float32) - o
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    t_max = dist.astype(np.float32)
    t_max[::7] = 0.0  # lanes that trace nothing
    mask = torch.as_tensor(rng.random(64) > 0.4)
    return (scene, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(t_max), mask)


def _k3(scene, o, d, t_max, t_min=T_MIN):
    frame = scene["frame"]
    return trace_bvh.trace_any_bvh(scene["geom"]["packed9"],
                                   frame["bvh_bounds"], frame["bvh_meta"],
                                   o, d, t_min, t_max)


@pytest.mark.parametrize("boxes", ["all", "masked"])
def test_k7_plain_matches_pallas(case, boxes):
    scene, o, d, t_max, mask = case
    mn, mx = scene["frame"]["wc_aabb_min_w"], scene["frame"]["wc_aabb_max_w"]
    jmn, jmx = _j(mn), _j(mx)
    if boxes == "masked":
        mn, mx = _masked_aabbs(mn, mx, mask)
        jmn, jmx = j_masked_aabbs(jmn, jmx, _j(mask))
    slabs = scene["geom"]["packed9"]
    got = trace_flat.trace_any_flat(slabs, mn, mx, o, d, T_MIN, t_max)
    with interpret_mode():
        want = trace_pallas.trace_any_pallas(_j(slabs), jmn, jmx, _j(o),
                                             _j(d), T_MIN, _j(t_max))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.1 < float(got.float().mean()) < 0.9
    assert not got[::7].any()
    assert trace_flat.trace_any_flat.launches == 0  # CPU: plain version


@pytest.mark.parametrize("skip", ["none", "mask", "all_true", "all_false"])
def test_k10_plain_matches_pallas(case, skip):
    """The skip mask keeps the clusters it marks True, as K4's
    (trace_bvh.py `_dense_aux` :1121-1123): held against the Pallas
    kernel, not assumed."""
    scene, o, d, t_max, mask = case
    frame = scene["frame"]
    m = {"none": None, "mask": mask, "all_true": torch.ones_like(mask),
         "all_false": torch.zeros_like(mask)}[skip]
    args = (scene["geom"]["packed9"], frame["bvh_bounds"], frame["bvh_meta"])
    got = trace_bvh.trace_any_bvh_dense(*args, o, d, T_MIN, t_max,
                                        skip_mask=m)
    with interpret_mode():
        want = jtrace_bvh.trace_any_bvh_dense(
            *(_j(a) for a in args), _j(o), _j(d), T_MIN, _j(t_max),
            skip_mask=None if m is None else _j(m.to(torch.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = _k3(scene, o, d, t_max)
    if skip in ("none", "all_true"):
        assert torch.equal(got, full)
    elif skip == "all_false":
        assert not got.any()
    else:  # a strict subset of the occluders is left
        assert bool((got <= full).all()) and int(got.sum()) < int(full.sum())
    assert trace_bvh.trace_any_bvh_dense.launches == 0


def test_any_kernels_match_k3(case):
    """K7 over the unmasked AABBs and K10 give K3's occlusion."""
    scene, o, d, t_max, _ = case
    frame = scene["frame"]
    slabs = scene["geom"]["packed9"]
    want = _k3(scene, o, d, t_max)
    k7 = trace_flat.trace_any_flat(slabs, frame["wc_aabb_min_w"],
                                   frame["wc_aabb_max_w"], o, d, T_MIN, t_max)
    k10 = trace_bvh.trace_any_bvh_dense(slabs, frame["bvh_bounds"],
                                        frame["bvh_meta"], o, d, T_MIN, t_max)
    assert torch.equal(k7, want) and torch.equal(k10, want)
    assert 0.1 < float(want.float().mean()) < 0.9


@pytest.mark.parametrize("t_lim", [0.0, 0.05, 0.1])
def test_no_hit_at_or_below_t_min(case, t_lim):
    """A lane with t_max <= t_min has no t in (t_min, t_max): never
    occluded, whatever its tile holds."""
    scene, o, d, t_max, _ = case
    frame = scene["frame"]
    slabs = scene["geom"]["packed9"]
    t = torch.where(torch.arange(R) % 2 == 0, t_lim, t_max)
    for occ in (
        trace_flat.trace_any_flat(slabs, frame["wc_aabb_min_w"],
                                  frame["wc_aabb_max_w"], o, d, T_MIN, t),
        trace_bvh.trace_any_bvh_dense(slabs, frame["bvh_bounds"],
                                      frame["bvh_meta"], o, d, T_MIN, t),
    ):
        assert not occ[::2].any()
        assert torch.equal(occ[1::2], _k3(scene, o, d, t)[1::2])


def test_k7_mask_does_not_depend_on_ray_order(case):
    """The packet cull depends on which rays share a tile, the mask does
    not: a permuted set gives the permuted mask."""
    scene, o, d, t_max, _ = case
    frame = scene["frame"]
    args = (scene["geom"]["packed9"], frame["wc_aabb_min_w"],
            frame["wc_aabb_max_w"])
    perm = torch.as_tensor(np.random.default_rng(9).permutation(R))
    base = trace_flat.trace_any_flat(*args, o, d, T_MIN, t_max)
    again = trace_flat.trace_any_flat(*args, o[perm], d[perm], T_MIN,
                                      t_max[perm])
    assert torch.equal(again, base[perm])


def test_dense_aux_matches_jax(case):
    """Cluster -> leaf node, the leaf boxes and the dead flags equal the
    JAX tables (trace_bvh.py `_dense_aux`) on the real clusters."""
    scene, _, _, _, mask = case
    frame = scene["frame"]
    C = scene["geom"]["packed9"].shape[0]
    node_of, cmin, cmax, dead = trace_bvh.dense_aux(
        C, frame["bvh_bounds"], frame["bvh_meta"], mask)
    j_node_of, caabb8 = jtrace_bvh._dense_aux(
        C, _j(frame["bvh_bounds"]), _j(frame["bvh_meta"]),
        _j(mask.to(torch.int32)))
    np.testing.assert_array_equal(node_of.numpy(), np.asarray(j_node_of)[0])
    caabb8 = np.asarray(caabb8)
    np.testing.assert_array_equal(cmin.numpy(), caabb8[0:3, :C].T)
    np.testing.assert_array_equal(cmax.numpy(), caabb8[3:6, :C].T)
    np.testing.assert_array_equal(dead.numpy(), caabb8[6, :C] == 1.0)
    assert (caabb8[6, C:] == 1.0).all()  # JAX's pad clusters: dead


def test_make_tracer_any_policy(case, monkeypatch):
    """config.policy.any_tracer, read at each call: "stack" K3 and
    "dense" K10 on a BVH frame; K7 without BVH arrays whatever the
    policy; an unknown name raises."""
    scene, o, d, t_max, _ = case
    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bvh = ttrace.frame_bvh(frame)
    want = _k3(scene, o, d, t_max)
    for policy, bvh_arg, fn in (
        ("stack", bvh, trace_bvh.trace_any_bvh),
        ("dense", bvh, trace_bvh.trace_any_bvh_dense),
        ("stack", None, trace_flat.trace_any_flat),
        ("dense", None, trace_flat.trace_any_flat),
    ):
        monkeypatch.setattr(config.policy, "any_tracer", policy)
        _, any_fn = ttrace.make_tracer(slabs, mn, mx, bvh=bvh_arg)
        assert any_fn.func is fn
        assert torch.equal(any_fn(o, d, T_MIN, t_max), want)
    monkeypatch.setattr(config.policy, "any_tracer", "wide")
    with pytest.raises(ValueError, match="any_tracer"):
        ttrace.make_tracer(slabs, mn, mx, bvh=bvh)


def test_any_wrappers_refuse_other_devices(case):
    scene, o, d, t_max, _ = case
    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    meta_dev = [t.to("meta") for t in (slabs, frame["wc_aabb_min_w"],
                                       frame["wc_aabb_max_w"], o, d)]
    with pytest.raises(ValueError, match="unsupported device"):
        trace_flat.trace_any_flat(*meta_dev, T_MIN, 1.0)
    meta_dev = [t.to("meta") for t in (slabs, frame["bvh_bounds"],
                                       frame["bvh_meta"], o, d)]
    with pytest.raises(ValueError, match="unsupported device"):
        trace_bvh.trace_any_bvh_dense(*meta_dev, T_MIN, 1.0)
    # the list and the bitmap of entered clusters, the staged rays, the
    # warps' counts and node stacks, the flag word
    assert trace_bvh.dense_list_bytes(2048) == (
        4 * (2048 + 64) + 4 * (7 * 128 + 4 * (1 + 64) + 1))
