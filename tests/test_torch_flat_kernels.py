"""The flat cull-list tracers of prosper_tpu_torch (ops/trace_flat.py: K6
`trace_closest_flat`, K8 `trace_closest_flat_full`, as their plain
PyTorch versions) against the Pallas kernels of prosper_tpu they replace
(`trace_pallas.trace_closest_pallas`, `trace_pallas_full.
trace_closest_full`), run in interpret mode on the CPU; the packet cull
(`packet_aabb_enter_exit`, `cull_lists`) against the JAX package's; and
the tracer policy of ops/trace.make_tracer.

Inputs: the plate-64 scene with blend and mask plates, the forward
pass's pixel-centre rays of a 48x40 frame in 16x16-block order (a short
last tile), and t_min 1e-4, which the Pallas kernels hard-code.

Tolerances: hit/miss exact; tri exact except where the two t agree
within 1e-6 relative (an exact tie); t within rtol 1e-5 (XLA and
PyTorch evaluate the same float32 Möller expressions, a few ulps apart);
interpolated attributes within atol 1e-4; the packet entry and exit
distances within rtol 1e-6, and the cull's overlap sets and list order
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import intersect as jintersect
from prosper_tpu.ops import trace_pallas, trace_pallas_full
from prosper_tpu.render.gbuffer import _masked_aabbs as j_masked_aabbs
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import intersect, trace_bvh, trace_flat
from prosper_tpu_torch.ops import trace as ttrace
from prosper_tpu_torch.render.forward import pixel_center_rays
from prosper_tpu_torch.render.gbuffer import _masked_aabbs
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
W, H = 48, 40


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.fixture(scope="module")
def case():
    """The plate-64 scene, the block-order rays and a cluster mask (the
    opaque pass's: every cluster but the blend plates)."""
    static, frame, arena, cam_fn = ttesting.make_plate_scene(
        64, 0, blend_every=8, mask_every=8)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    cam = camera_tensors(cam_fn(W, H), "cpu")
    o, d = pixel_center_rays(cam, W, H, "cpu")
    keep = torch.as_tensor(static["materials"]["alpha_mode"][
        static["wc_material"]] != 2)
    return scene, o, d, keep


def _boxes(scene, keep, kind):
    mn, mx = scene["frame"]["wc_aabb_min_w"], scene["frame"]["wc_aabb_max_w"]
    if kind == "all":
        return mn, mx
    if kind == "none":
        keep = torch.zeros_like(keep)
    return _masked_aabbs(mn, mx, keep)


def _t_max(kind, R):
    t_max = np.full(R, np.inf, np.float32)
    if kind == "some_zero":
        t_max[::7] = 0.0  # lanes the alpha retrace leaves out
        t_max[256:512] = 0.0  # and a whole tile of them
    return t_max


def _assert_rows(got, t, tri, attrs=None):
    got = got.numpy()
    t, tri = np.asarray(t), np.asarray(tri)
    np.testing.assert_array_equal(got[:, 1] >= 0, tri >= 0)
    both = tri >= 0
    with np.errstate(invalid="ignore"):  # inf - inf on misses
        tie = np.abs(got[:, 0] - t) <= 1e-6 * np.abs(t)
    assert ((got[:, 1] == tri) | ~both | tie).all()
    np.testing.assert_allclose(got[both, 0], t[both], rtol=1e-5)
    np.testing.assert_array_equal(got[~both, 0], t[~both])
    if attrs is not None:
        same = both & (got[:, 1] == tri)
        for cols, want in attrs:
            np.testing.assert_allclose(got[same][:, cols],
                                       np.asarray(want)[same], atol=1e-4)


@pytest.mark.parametrize("boxes", ["all", "masked", "none"])
@pytest.mark.parametrize("tmax", ["inf", "some_zero"])
def test_k6_plain_matches_pallas(case, boxes, tmax):
    scene, o, d, keep = case
    mn, mx = _boxes(scene, keep, boxes)
    t_max = _t_max(tmax, o.shape[0])
    slabs = scene["geom"]["packed9"]
    got = trace_flat.trace_closest_flat(slabs, mn, mx, o, d, 1e-4,
                                        torch.as_tensor(t_max))
    with interpret_mode():
        want = trace_pallas.trace_closest_pallas(
            _j(slabs), _j(mn), _j(mx), _j(o), _j(d), 1e-4, jnp.asarray(t_max))
    _assert_rows(got, want["t"], want["tri"],
                 [(2, want["u"]), (3, want["v"])])
    hits = got[:, 1] >= 0
    if boxes == "none":
        assert not hits.any()
    else:
        assert 0.2 < float(hits.float().mean()) < 0.9
    if boxes == "masked":
        assert keep[got[hits, 1].long() // 128].all()
    if tmax == "some_zero":
        assert not hits[::7].any() and not hits[256:512].any()
    assert trace_flat.trace_closest_flat.launches == 0  # CPU: plain version


@pytest.mark.parametrize("boxes", ["all", "masked", "none"])
def test_k8_plain_matches_pallas(case, boxes):
    scene, o, d, keep = case
    mn, mx = _boxes(scene, keep, boxes)
    slabs = scene["geom"]["packed_full"]
    t_max = _t_max("some_zero", o.shape[0])
    got = trace_flat.trace_closest_flat_full(slabs, mn, mx, o, d, 1e-4,
                                             torch.as_tensor(t_max))
    with interpret_mode():
        want = trace_pallas_full.trace_closest_full(
            _j(slabs), _j(mn), _j(mx), _j(o), _j(d), 1e-4, jnp.asarray(t_max))
    _assert_rows(got, want["t"], want["tri"], [
        (slice(2, 5), want["normal"]), (slice(5, 9), want["tangent"]),
        (slice(9, 11), want["uv"]), (11, want["material"]),
        (12, want["tri_lod"])])
    miss = got[:, 1] < 0
    assert (got[miss, 2:] == 0).all()
    assert trace_flat.trace_closest_flat_full.launches == 0


def test_k8_rows_extend_k6_rows(case):
    """K8's t and tri are K6's; its attributes are those of the hit
    triangle (ops/slabs.attrs_from_hit_rows of K6's rows)."""
    from prosper_tpu_torch.ops import slabs as tslabs

    scene, o, d, keep = case
    mn, mx = _boxes(scene, keep, "masked")
    h8 = trace_flat.trace_closest_flat(scene["geom"]["packed_full"], mn, mx,
                                       o, d, 1e-4, float("inf"))
    h16 = trace_flat.trace_closest_flat_full(scene["geom"]["packed_full"], mn,
                                             mx, o, d, 1e-4, float("inf"))
    assert torch.equal(h16[:, :2], h8[:, :2])
    want = tslabs.pack_hit16(tslabs.attrs_from_hit_rows(
        scene["geom"]["attr_rows"], tslabs.unpack_hit8(h8)))
    torch.testing.assert_close(h16, want, rtol=1e-6, atol=1e-6)


def test_packet_enter_exit_matches_jax():
    """Random packets against random, degenerate (flat) and inverted
    boxes, with sign-mixed direction intervals among them."""
    rng = np.random.default_rng(5)
    P, A = 64, 96
    o_lo = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    o_hi = o_lo + rng.uniform(0, 0.5, (P, 3)).astype(np.float32)
    d_lo = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    d_hi = d_lo + rng.uniform(0, 0.4, (P, 3)).astype(np.float32)
    bmin = rng.uniform(-8, 8, (A, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 3, (A, 3)).astype(np.float32)
    bmax[::5, 1] = bmin[::5, 1]  # flat boxes
    mask = rng.random(A) > 0.3
    bmin, bmax = (np.array(a) for a in j_masked_aabbs(
        jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(mask)))
    args = (o_lo[:, None], o_hi[:, None], d_lo[:, None], d_hi[:, None],
            bmin[None], bmax[None])
    want = jintersect.packet_aabb_enter_exit(*(jnp.asarray(a) for a in args))
    got = intersect.packet_aabb_enter_exit(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    enter, exit_ = (g.numpy() for g in got)
    assert (enter[:, ~mask] == 3e38).all() and (exit_[:, ~mask] == -3e38).all()
    overlap = (enter <= exit_) & (exit_ >= 0)
    assert 0.05 < overlap[:, mask].mean() < 0.95


def test_cull_lists_match_jax(case):
    """Per-tile lists of the masked opaque pass: the same overlap sets in
    the same front-to-back order as trace_pallas._cull_lists."""
    scene, o, d, keep = case
    mn, mx = _boxes(scene, keep, "masked")
    lists, counts, keys = trace_flat.cull_lists(o, d, 1e-4, float("inf"),
                                                mn, mx)
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    pad = (-o.shape[0]) % 256
    oj = jnp.concatenate([oj, jnp.broadcast_to(oj[-1:], (pad, 3))])
    dj = jnp.concatenate([dj, jnp.broadcast_to(dj[-1:], (pad, 3))])
    T = oj.shape[0] // 256
    jl, jc, jk = trace_pallas._cull_lists(
        oj.reshape(T, 256, 3), dj.reshape(T, 256, 3),
        jnp.full((T,), jnp.inf), _j(mn), _j(mx), 64)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for t in range(T):
        n = int(counts[t])
        np.testing.assert_array_equal(lists[t, :n].numpy(),
                                      np.asarray(jl)[t, :n])
        np.testing.assert_allclose(keys[t, :n].numpy(),
                                   np.asarray(jk)[t, :n], rtol=1e-6)
    assert 0 < int(counts.min()) and int(counts.max()) < int(keep.sum())
    assert keep[lists[0, :int(counts[0])].long()].all()


def test_make_tracer_policy(case):
    """BVH arrays: K2 closest and K3 any hit; none: K6 closest and K7 any
    hit, with K3's occlusion."""
    scene, o, d, keep = case
    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bvh = ttrace.frame_bvh(frame)
    closest, any_fn = ttrace.make_tracer(slabs, mn, mx, bvh=bvh)
    assert closest.func is trace_bvh.trace_closest_bvh
    assert any_fn.func is trace_bvh.trace_any_bvh
    want = closest(o, d, 1e-4, float("inf"))
    closest, any_fn = ttrace.make_tracer(slabs, mn, mx)
    assert closest.func is trace_flat.trace_closest_flat
    got = closest(o, d, 1e-4, float("inf"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any_fn.func is trace_flat.trace_any_flat
    occ = any_fn(o, d, 0.1, 5.0)
    assert torch.equal(occ, trace_bvh.trace_any_bvh(slabs, *bvh, o, d, 0.1,
                                                    5.0))
    assert occ.any()
    assert ttrace.frame_bvh({"wc_aabb_min_w": mn}) is None


def test_flat_wrapper_dispatch(case):
    """CPU tensors take the plain version; a device that is neither CPU
    nor CUDA is refused."""
    scene, o, d, keep = case
    mn, mx = _boxes(scene, keep, "all")
    meta = [t.to("meta") for t in (scene["geom"]["packed9"], mn, mx, o, d)]
    for fn in trace_flat.KERNELS:
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta, 1e-4, float("inf"))
    assert trace_flat.list_bytes(2048) == 4 * (2 * 2048 + 6 * 64)
    assert trace_flat.list_bytes(2049) == 4 * (2 * 4096 + 6 * 128)
    assert trace_flat.list_bytes(1) == 4 * (2 + 6)
    assert trace_flat.list_bytes(16385) == 4 * (2 * 32768 + 6 * 1024)
