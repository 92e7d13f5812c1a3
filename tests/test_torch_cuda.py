"""The CUDA kernels against their plain PyTorch versions, and the
frames on the card against the CPU frames. Skipped where torch sees no
GPU. The card's machine has no JAX, which tests/conftest.py imports, so
there run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states them: hit/miss and occlusion equal,
tri equal except exact t ties, t within rtol 1e-5, attributes 1e-4; the
shading kernel within rtol 1e-5 / atol 1e-6 of its plain version; the
pair-block kernel's slots equal to its plain version's; K2's rows 0-5
equal to the lockstep plain walk's and the counting K2's bit for bit,
ties included, and K1's and K4's rows 0-15 to the lockstep plain walk's
(under K4's skip mask) and the counting K2's through the attribute
interpolation, bit for bit; the 8-wide kernels, the threaded walk, the
counting K2, the Möller loops and the loop probes equal to their plain
versions bit for bit; the tensor-core Plücker loops agree with their TF32 plain versions on every hit off the
border of ops/plucker.tf32_agreement, with t within rtol 1e-5 plus the
bound of a reordered sum where both hit, and with Möller on at least
99.95% of (ray, triangle) pairs (experiments/bench_mxu_isect.py:89) with
t within rtol 1e-2 where both hit."""

import numpy as np
import pytest
import torch

from prosper_tpu_torch.accel.bvh import build_bvh, pack_nodes8
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.experiments import bench_mxu_isect as bmi
from prosper_tpu_torch.experiments import trace_wavefront as tw
from prosper_tpu_torch.ops import bench_kernels as bk
from prosper_tpu_torch.ops.plucker import (
    plucker_rows_from_slab,
    tf32_agreement,
)
from prosper_tpu_torch.ops import shade_tiles as tst
from prosper_tpu_torch.ops import trace_bvh as tb
from prosper_tpu_torch.ops import trace_flat as tf
from prosper_tpu_torch.ops import trace_leafmajor as lm
from prosper_tpu_torch.render import forward, gbuffer, pt, shading
from prosper_tpu_torch.scene.camera import (
    Camera,
    CameraParameters,
    CameraTransform,
)
from prosper_tpu_torch.scene.convert import camera_tensors
from prosper_tpu_torch.testing import make_tie_scene

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rows_agree(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, 1] >= 0, want[:, 1] >= 0)
    both = (got[:, 1] >= 0) & (want[:, 1] >= 0)
    with np.errstate(invalid="ignore"):  # inf - inf on misses
        tie = np.abs(got[:, 0] - want[:, 0]) <= 1e-6 * np.abs(want[:, 0])
    assert ((got[:, 1] == want[:, 1]) | tie)[both].all()
    np.testing.assert_allclose(got[both, 0], want[both, 0], rtol=1e-5,
                               atol=1e-6)
    same = both & (got[:, 1] == want[:, 1])
    np.testing.assert_allclose(got[same, 2:], want[same, 2:], atol=1e-4)


@pytest.mark.parametrize("scene,n", [("test", 4), ("plate", 64)])
def test_kernels_match_plain_on_card(cuda, scene, n):
    fn, (sc, cam, _) = entry(cuda, scene=scene, n_clusters=n, width=128,
                             height=96, max_bounces=2)
    geom, frame = sc["geom"], sc["frame"]
    bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]
    _, _, cols, _ = pt._pixel_layouts(128, 96, str(cuda))
    cam_vec = tb.primary_cam_vec(cam, 128, 96, device=cuda)
    tb.reset_launch_counts()
    h16 = tb.trace_primary_bvh_full(geom["packed_full"], bounds, meta, cols,
                                    cam_vec, 5, 0.0)
    _rows_agree(h16, tb.trace_primary_bvh_full_plain(
        geom["packed_full"], bounds, meta, cols, cam_vec, 5, 0.0))

    rng = np.random.default_rng(n)
    R = 5000
    # rays from around the camera in random directions
    o = cam["eye"].expand(R, 3) + torch.as_tensor(
        rng.normal(size=(R, 3)), dtype=torch.float32, device=cuda)
    d = torch.as_tensor(rng.normal(size=(R, 3)), dtype=torch.float32,
                        device=cuda)
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((R,), float("inf"), device=cuda)
    t_max[::9] = 0.0
    got = tb.trace_closest_bvh(geom["packed_full"], bounds, meta, o, d, 0.0,
                               t_max)
    _rows_agree(got, tb.trace_closest_bvh_plain(geom["packed_full"], bounds,
                                                meta, o, d, 0.0, t_max))
    t_max = torch.full((R,), 20.0, device=cuda)
    occ = tb.trace_any_bvh(geom["packed9"], bounds, meta, o, d, 0.1, t_max)
    want = tb.trace_any_bvh_plain(geom["packed9"], bounds, meta, o, d, 0.1,
                                  t_max)
    assert torch.equal(occ, want)
    tb.check_stack_overflow(cuda)
    assert [f.launches for f in tb.KERNELS] == [1, 1, 1] + [0] * (
        len(tb.KERNELS) - 3)


def _random_rays(cam, R, seed, device):
    """R rays from around the camera in random directions."""
    rng = np.random.default_rng(seed)
    o = cam["eye"].expand(R, 3) + torch.as_tensor(
        rng.normal(size=(R, 3)), dtype=torch.float32, device=device)
    d = torch.as_tensor(rng.normal(size=(R, 3)), dtype=torch.float32,
                        device=device)
    return o.contiguous(), (d / d.norm(dim=1, keepdim=True)).contiguous()


def test_closest_full_matches_plain_on_card(cuda):
    """K4 with and without a cluster skip mask; no hit on a masked
    cluster."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    geom, frame = sc["geom"], sc["frame"]
    args = (geom["packed_full"], frame["bvh_bounds"], frame["bvh_meta"])
    o, d = _random_rays(cam, 5000, 11, cuda)
    t_max = torch.full((5000,), float("inf"), device=cuda)
    t_max[::9] = 0.0
    mask = torch.as_tensor(np.random.default_rng(1).random(64) > 0.4,
                           device=cuda)
    tb.reset_launch_counts()
    for m in (None, mask):
        got = tb.trace_closest_bvh_full(*args, o, d, 1e-4, t_max,
                                        skip_mask=m)
        _rows_agree(got, tb.trace_closest_bvh_full_plain(
            *args, o, d, 1e-4, t_max, skip_mask=m))
    tri = got[:, 1].long()
    assert mask[tri[tri >= 0] // 128].all()
    tb.check_stack_overflow(cuda)
    assert tb.trace_closest_bvh_full.launches == 2


def test_primary_gbuffer_form_matches_plain_on_card(cuda):
    """K1 with a TAA-jittered camera (pcg_on = 0, pixel offsets)."""
    fn, (sc, _, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                           height=32)
    c = Camera((96, 64), CameraParameters(),
               CameraTransform(eye=np.array([12.0, 9.0, 14.0], np.float32),
                               target=np.array([2.0, 2.0, 2.0], np.float32)),
               apply_jitter=True)
    c._jitter_index = 3
    c.update()
    cam = camera_tensors(c.uniforms(), cuda)
    cols = gbuffer._row_pixels(96, 64, str(cuda))
    vec = tb.primary_cam_vec(cam, 96, 64, pixel_jitter=cam["current_jitter"],
                             device=cuda)
    args = (sc["geom"]["packed_full"], sc["frame"]["bvh_bounds"],
            sc["frame"]["bvh_meta"], cols, vec, 0, 1e-4)
    got = tb.trace_primary_bvh_full(*args)
    _rows_agree(got, tb.trace_primary_bvh_full_plain(*args))
    assert (got[:, 1] >= 0).any()
    tb.check_stack_overflow(cuda)


@pytest.mark.parametrize("use_culling", [False, True])
def test_shade_tiles_match_plain_on_card(cuda, monkeypatch, use_culling):
    """K5 on the G-buffer of a deferred frame with ragged froxel tiles
    (80x56) and 200 scattered lights, against its plain version."""
    W, H = 80, 56
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=W,
                             height=H, mode="deferred",
                             use_culling=use_culling, scatter_lights=200)
    real, seen = shading.shade_clustered_tiles, []

    def record(inp, width, height):
        seen.append(inp)
        return real(inp, width, height)

    monkeypatch.setattr(shading, "shade_clustered_tiles", record)
    tst.shade_clustered_tiles.launches = 0
    tb.reset_launch_counts()
    img, state, drawn = fn(sc, cam, 0)
    assert tst.shade_clustered_tiles.launches == 1
    k4 = tb.trace_closest_bvh_full.launches
    assert (k4, tb.trace_primary_bvh_full.launches) == (
        (2, 0) if use_culling else (0, 1))
    inp = seen[0]
    assert int(inp["counts"].max()) == 200
    got = tst.shade_clustered_tiles(inp, W, H)
    want = tst.shade_clustered_tiles_plain(inp, W, H)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (got > 0).any() and bool(torch.isfinite(img).all())


def test_stack_overflow_raises_on_card(cuda):
    """A BVH chain whose far children pile up on the node stack: the
    kernel sets the device's overflow flag, check_stack_overflow raises
    once and clears it."""
    fn, (sc, cam, _) = entry(cuda, width=32, height=32)
    L = tb.STACK_CAP + 6  # internal nodes 0..L-1, leaves L..2L
    left = [i + 1 for i in range(L - 1)] + [2 * L]
    meta = torch.tensor(
        [[left[i], L + i, -1] for i in range(L)] + [[-1, -1, 0]] * (L + 1),
        dtype=torch.int32, device=cuda,
    )
    # every node has the same box, so the left (internal) child is near
    bounds = torch.tensor([[-10.0, -10.0, -10.0, 10.0, 10.0, 10.0]],
                          device=cuda).expand(2 * L + 1, 6).contiguous()
    o = torch.tensor([[0.0, 0.0, -50.0]], device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda)
    tb.trace_closest_bvh(sc["geom"]["packed_full"], bounds, meta, o, d, 0.0,
                         float("inf"))
    with pytest.raises(RuntimeError, match="stack overflow"):
        tb.check_stack_overflow(cuda)
    tb.check_stack_overflow(cuda)  # cleared


def test_frame_on_card_matches_cpu(cuda):
    """The whole frame on the card against the same frame on the CPU:
    equal ray counts, at most 1% of pixels off by more than 1e-3."""
    fn_g, args_g = entry(cuda, width=64, height=64, max_bounces=3)
    fn_c, args_c = entry("cpu", width=64, height=64, max_bounces=3)
    img_g, _, n_g = fn_g(*args_g)
    img_c, _, n_c = fn_c(*args_c)
    assert int(n_g) == int(n_c)
    off = ((img_g.cpu() - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


@pytest.mark.parametrize("use_culling", [False, True])
def test_deferred_frame_on_card_matches_cpu(cuda, use_culling):
    """Two deferred frames (the second culls against the first's HiZ) on
    the card against the CPU: at most 1% of pixels off by more than
    1e-3, equal drawn-meshlet counts."""
    kw = dict(scene="plate", n_clusters=64, width=64, height=64,
              mode="deferred", use_culling=use_culling, scatter_lights=100)
    out = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, **kw)
        _, state, _ = fn(sc, cam, 0)
        img, _, drawn = fn(sc, cam, 1, state)
        out.append((img.cpu(), int(drawn)))
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def test_wrapper_checks_inputs_on_card(cuda):
    fn, (sc, cam, _) = entry(cuda, width=32, height=32)
    geom, frame = sc["geom"], sc["frame"]
    o = torch.zeros((8, 3), device=cuda)
    with pytest.raises(TypeError):
        tb.trace_closest_bvh(geom["packed_full"], frame["bvh_bounds"],
                             frame["bvh_meta"], o.double(), o, 0.0, 1.0)
    with pytest.raises(ValueError):
        tb.trace_any_bvh(geom["packed9"], frame["bvh_bounds"],
                         frame["bvh_meta"], o, o.cpu(), 0.1, 1.0)


@pytest.mark.parametrize("full", [False, True], ids=["K6", "K8"])
def test_flat_kernels_match_plain_on_card(cuda, full):
    """K6 and K8 against their plain versions on a 200x120 block-order
    wavefront (a short last tile) and on random rays with t_max = 0
    lanes: over the cluster AABBs, over masked AABBs (no hit on a masked
    cluster) and with every cluster masked (every ray misses)."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32, blend_every=8, mask_every=8)
    slabs = sc["geom"]["packed_full" if full else "packed9"]
    kern, plain = ((tf.trace_closest_flat_full, tf.trace_closest_flat_full_plain)
                   if full else (tf.trace_closest_flat, tf.trace_closest_flat_plain))
    frame = sc["frame"]
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    mask = torch.as_tensor(np.random.default_rng(2).random(64) > 0.3,
                           device=cuda)
    boxes = {"all": (mn, mx), "masked": gbuffer._masked_aabbs(mn, mx, mask),
             "none": gbuffer._masked_aabbs(mn, mx, torch.zeros_like(mask))}
    o_b, d_b = forward.pixel_center_rays(cam, 200, 120, cuda)
    o_r, d_r = _random_rays(cam, 5000, 3, cuda)
    t_r = torch.full((5000,), float("inf"), device=cuda)
    t_r[::9] = 0.0
    t_r[:256] = 0.0  # a whole tile of disabled lanes
    kern.launches = 0
    for name, (bmin, bmax) in boxes.items():
        for o, d, t_min, t_max in ((o_b, d_b, 1e-4, float("inf")),
                                   (o_r, d_r, 0.0, t_r)):
            got = kern(slabs, bmin, bmax, o, d, t_min, t_max)
            torch.cuda.synchronize()
            _rows_agree(got, plain(slabs, bmin, bmax, o, d, t_min, t_max))
            tri = got[:, 1].long()
            if name == "none":
                assert (tri < 0).all()
            else:
                assert (tri >= 0).any()
            if name == "masked":
                assert mask[tri[tri >= 0] // 128].all()
            assert got.shape[1] == (16 if full else 8)
    assert kern.launches == 6


def test_flat_closest_matches_bvh_on_card(cuda):
    """K6 over the unmasked AABBs and K2 over the BVH give the same hits
    on the forward rays, and K8 the same rows as K4."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    geom, frame = sc["geom"], sc["frame"]
    o, d = forward.pixel_center_rays(cam, 160, 96, cuda)
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    got = tf.trace_closest_flat(geom["packed9"], mn, mx, o, d, 1e-4,
                                float("inf"))
    want = tb.trace_closest_bvh(geom["packed9"], *bvh, o, d, 1e-4,
                                float("inf"))
    _rows_agree(got, want)
    assert (got[:, 1] >= 0).any()
    got = tf.trace_closest_flat_full(geom["packed_full"], mn, mx, o, d, 1e-4,
                                     float("inf"))
    want = tb.trace_closest_bvh_full(geom["packed_full"], *bvh, o, d, 1e-4,
                                     float("inf"))
    _rows_agree(got, want)
    tb.check_stack_overflow(cuda)


def test_flat_wrapper_refuses_too_many_clusters(cuda):
    """A cull list larger than a block's shared memory raises instead of
    dropping clusters."""
    n = 40000
    slabs = torch.zeros((n, 9, 128), device=cuda)
    box = torch.zeros((n, 3), device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tf.trace_closest_flat(slabs, box, box, o, o + 1.0, 0.0, 1.0)


@pytest.mark.parametrize("kw", [
    {},
    {"blend_every": 8, "mask_every": 8},
    {"blend_every": 8, "mask_every": 8, "bvh": False},
    {"blend_every": 8, "mask_every": 8, "draw_type": 6},
], ids=["opaque", "blend_mask", "blend_mask_no_bvh", "debug_normal"])
def test_forward_frame_on_card_matches_cpu(cuda, kw):
    """Forward frames on the card against the CPU: equal covered-pixel
    counts, at most 1% of pixels off by more than 1e-3."""
    out = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, scene="plate", n_clusters=64, width=64,
                                 height=64, mode="forward",
                                 scatter_lights=100, **kw)
        img, _, n = fn(sc, cam, 0)
        out.append((img.cpu(), int(n)))
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c > 0
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def test_transparent_deferred_without_bvh_on_card_matches_cpu(cuda):
    """The culled deferred frame with the transparent pass and alpha
    discard on a frame without BVH arrays (K8 throughout) against the
    CPU."""
    kw = dict(scene="plate", n_clusters=64, width=64, height=64,
              mode="deferred", use_culling=True, scatter_lights=100,
              blend_every=8, mask_every=8, bvh=False)
    out = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, **kw)
        _, state, _ = fn(sc, cam, 0)
        img, _, drawn = fn(sc, cam, 1, state)
        out.append((img.cpu(), int(drawn)))
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def _shadow_segments(cam, R, seed, device, scene):
    """R segments from around the camera to random points of the scene's
    cluster bounds, as shadow rays: (o, d, t_max = the length); every
    ninth lane and a whole tile disabled with t_max = 0."""
    frame = scene["frame"]
    lo = frame["wc_aabb_min_w"].amin(0)
    hi = frame["wc_aabb_max_w"].amax(0)
    rng = np.random.default_rng(seed)
    o, _ = _random_rays(cam, R, seed, device)
    tgt = lo + (hi - lo) * torch.as_tensor(rng.random((R, 3)),
                                           dtype=torch.float32, device=device)
    d = tgt - o
    t_max = d.norm(dim=1)
    d = (d / t_max[:, None]).contiguous()
    t_max[::9] = 0.0
    t_max[256:512] = 0.0
    return o, d, t_max


@pytest.mark.parametrize("kind", ["K7", "K7_masked", "K10", "K10_skip"])
def test_any_kernels_match_plain_and_k3_on_card(cuda, kind):
    """K7 and K10 against their plain versions and against K3 on shadow
    segments and on the forward pass's block-order rays with t_max 3:
    occlusion equal, lanes with t_max <= t_min never occluded."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32, scatter_lights=16)
    frame, slabs = sc["frame"], sc["geom"]["packed9"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    mask = torch.as_tensor(np.random.default_rng(5).random(64) > 0.4,
                           device=cuda)
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    if kind == "K7_masked":
        mn, mx = gbuffer._masked_aabbs(mn, mx, mask)
    if kind.startswith("K7"):
        kern, plain, args, kw = (tf.trace_any_flat, tf.trace_any_flat_plain,
                                 (slabs, mn, mx), {})
    else:
        kern, plain, args = (tb.trace_any_bvh_dense,
                             tb.trace_any_bvh_dense_plain, (slabs, *bvh))
        kw = {"skip_mask": mask} if kind == "K10_skip" else {}
    o_b, d_b = forward.pixel_center_rays(cam, 200, 120, cuda)
    sets = [_shadow_segments(cam, 5000, 8, cuda, sc),
            (o_b, d_b, torch.full((o_b.shape[0],), 3.0, device=cuda))]
    kern.launches = 0
    for o, d, t_max in sets:
        got = kern(*args, o, d, 0.1, t_max, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(*args, o, d, 0.1, t_max, **kw))
        assert not got[t_max <= 0.1].any()
        assert got.any() and not got.all()
        k3 = tb.trace_any_bvh(slabs, *bvh, o, d, 0.1, t_max)
        if kind in ("K7", "K10"):
            assert torch.equal(got, k3)
        else:  # fewer live clusters: a subset of K3's occluders
            assert bool((got <= k3).all())
    tb.check_stack_overflow(cuda)
    assert kern.launches == 2


def test_any_wrappers_refuse_too_many_clusters(cuda):
    """A list larger than a block's shared memory raises instead of
    dropping clusters."""
    n = 60000
    slabs = torch.zeros((n, 9, 128), device=cuda)
    box = torch.zeros((n, 3), device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tf.trace_any_flat(slabs, box, box, o, o + 1.0, 0.1, 1.0)
    bounds = torch.zeros((1, 6), device=cuda)
    meta = torch.tensor([[-1, -1, 0]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tb.trace_any_bvh_dense(slabs, bounds, meta, o, o + 1.0, 0.1, 1.0)


@pytest.mark.parametrize("tracer", ["stack", "dense", "no_bvh"])
def test_restir_frame_on_card_matches_cpu(cuda, tracer, monkeypatch):
    """Two ReSTIR frames (accumulated) on the card against the CPU with
    BVH arrays under both any-hit policies and without them: equal
    shadow-ray counts, at most 1% of pixels off by more than 1e-3."""
    from prosper_tpu_torch import config

    monkeypatch.setattr(config.policy, "any_tracer",
                        "dense" if tracer == "dense" else "stack")
    kw = dict(scene="plate", n_clusters=64, width=64, height=64,
              mode="restir", scatter_lights=100, bvh=tracer != "no_bvh")
    out = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, **kw)
        _, state, _ = fn(sc, cam, 0)
        img, _, n = fn(sc, cam, 1, state)
        out.append((img.cpu(), int(n)))
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c > 0
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def test_pt_frame_without_bvh_on_card_matches_cpu(cuda):
    """The path tracer without BVH arrays (K8, K7) on the card against
    the CPU: equal ray counts, at most 1% of pixels off by more than
    1e-3."""
    out, launches = [], []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, scene="plate", n_clusters=64, width=64,
                                 height=64, max_bounces=3, bvh=False)
        tf.trace_any_flat.launches = tf.trace_closest_flat_full.launches = 0
        img, _, n = fn(sc, cam, 1)
        out.append((img.cpu(), int(n)))
        launches.append((tf.trace_closest_flat_full.launches,
                         tf.trace_any_flat.launches))
    assert launches == [(3, 3), (0, 0)]  # K8 primary + 2 bounces, K7 x3
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def _incoherent_rays(sc, R, seed, device):
    """R rays from random points of the scene's bounds in random
    directions, tile 0 a narrow cone from outside the grid; every ninth
    lane disabled, every seventh with t_max 6."""
    frame = sc["frame"]
    lo = frame["wc_aabb_min_w"].amin(0)
    hi = frame["wc_aabb_max_w"].amax(0)
    rng = np.random.default_rng(seed)
    o = lo + (hi - lo) * torch.as_tensor(rng.random((R, 3)),
                                         dtype=torch.float32, device=device)
    d = torch.as_tensor(rng.normal(size=(R, 3)), dtype=torch.float32,
                        device=device)
    o[:256] = lo - 1.0
    axis = (hi - lo) / (hi - lo).norm()
    d[:256] = axis + 0.02 * d[:256]
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((R,), float("inf"), device=device)
    t_max[::9] = 0.0
    t_max[1::7] = 6.0
    return o.contiguous(), d.contiguous(), t_max


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_run_pairs_matches_plain_on_card(cuda, any_hit):
    """K14 against its plain version on the blocks of every ray's first
    8 candidates (the non-hybrid enumeration): equal slots."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    frame, slabs = sc["frame"], sc["geom"]["packed_full"]
    o, d, t_max = _incoherent_rays(sc, 5000, 6, cuda)
    t_min = 0.1 if any_hit else 1e-4
    pairs = lm.enumerate_pairs_tiled(frame["wc_aabb_min_w"],
                                     frame["wc_aabb_max_w"], o, d, t_min,
                                     t_max)[:3]
    blocks = lm.build_blocks(*pairs, 64)[:3]
    lm.run_pairs.launches = 0
    got = lm.run_pairs(slabs, *blocks, o, d, t_min, t_max, any_hit)
    torch.cuda.synchronize()
    want = lm.run_pairs_plain(slabs, *blocks, o, d, t_min, t_max, any_hit)
    assert lm.run_pairs.launches == 1
    valid = blocks[2]
    if any_hit:
        assert torch.equal(got & valid, want & valid) and (got & valid).any()
    else:
        assert torch.equal(got[:, :2], want[:, :2])
        torch.testing.assert_close(got[:, 2:], want[:, 2:], rtol=0,
                                   atol=1e-6)
        assert (got[:, 1] >= 0).any()


def test_hybrid_matches_k2_k3_on_card(cuda):
    """The leaf-major hybrid against K2 and K3 on the same rays of the
    plate-160 scene (heavy tiles over VIS_CAP and one light tile); each
    of K14, K2 and K3 launches once per trace."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=160, width=32,
                             height=32)
    frame, slabs = sc["frame"], sc["geom"]["packed9"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    boxes = (frame["wc_aabb_min_w"], frame["wc_aabb_max_w"])
    o, d, t_max = _incoherent_rays(sc, 5000, 7, cuda)
    tb.reset_launch_counts()
    lm.run_pairs.launches = 0
    hit = lm.trace_closest_leafmajor_safe(slabs, *bvh, *boxes, o, d, 1e-4,
                                          t_max)
    occ = lm.trace_any_leafmajor_safe(slabs, *bvh, *boxes, o, d, 0.1, t_max)
    assert (lm.run_pairs.launches, tb.trace_closest_bvh.launches,
            tb.trace_any_bvh.launches) == (2, 1, 1)
    k2 = tb.trace_closest_bvh(slabs, *bvh, o, d, 1e-4, t_max)
    k3 = tb.trace_any_bvh(slabs, *bvh, o, d, 0.1, t_max)
    tb.check_stack_overflow(cuda)
    rows = torch.stack([torch.where(hit["tri"] >= 0, hit["t"], t_max),
                        hit["tri"].float(), hit["u"], hit["v"]], dim=1)
    _rows_agree(rows, k2[:, :4])
    assert torch.equal(occ, k3) and occ.any() and not occ.all()


@pytest.mark.parametrize("skip", [False, True], ids=["all", "skip_mask"])
def test_dense_closest_matches_plain_on_card(cuda, skip):
    """K9 against its plain version, and over every cluster against K2,
    on incoherent rays; with a skip mask no hit on a masked cluster."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    frame, slabs = sc["frame"], sc["geom"]["packed9"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    o, d, t_max = _incoherent_rays(sc, 5000, 8, cuda)
    mask = None
    if skip:
        mask = torch.as_tensor(np.random.default_rng(3).random(64) > 0.4,
                               device=cuda)
    tb.trace_closest_bvh_dense.launches = 0
    got = tb.trace_closest_bvh_dense(slabs, *bvh, o, d, 1e-4, t_max,
                                     skip_mask=mask)
    torch.cuda.synchronize()
    _rows_agree(got, tb.trace_closest_bvh_dense_plain(
        slabs, *bvh, o, d, 1e-4, t_max, skip_mask=mask))
    tri = got[:, 1].long()
    assert (tri >= 0).any()
    if skip:
        assert mask[tri[tri >= 0] // 128].all()
    else:
        _rows_agree(got, tb.trace_closest_bvh(slabs, *bvh, o, d, 1e-4, t_max))
        tb.check_stack_overflow(cuda)
    assert tb.trace_closest_bvh_dense.launches == 1


@pytest.mark.parametrize("mode", ["pt", "restir"])
def test_leafmajor_frames_on_card_match_cpu(cuda, mode, monkeypatch):
    """Frames under config.policy.bounce_tracer = "leafmajor" on the card
    against the CPU: equal ray or shadow-ray counts, at most 1% of pixels
    off by more than 1e-3; K14 ran on the card."""
    from prosper_tpu_torch import config

    monkeypatch.setattr(config.policy, "bounce_tracer", "leafmajor")
    kw = dict(scene="plate", n_clusters=64, width=64, height=64, mode=mode)
    if mode == "pt":
        kw["max_bounces"] = 3
    else:
        kw["scatter_lights"] = 100
    out = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, **kw)
        lm.run_pairs.launches = 0
        _, state, _ = fn(sc, cam, 0)
        img, _, n = fn(sc, cam, 1, state)
        out.append((img.cpu(), int(n), lm.run_pairs.launches))
    (img_g, n_g, k_g), (img_c, n_c, k_c) = out
    assert n_g == n_c > 0 and k_g > 0 and k_c == 0
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


def _nodes8(sc, device):
    frame = sc["frame"]
    bvh = build_bvh(frame["wc_aabb_min_w"].cpu().numpy(),
                    frame["wc_aabb_max_w"].cpu().numpy(), max_leaf_size=1)
    return torch.as_tensor(pack_nodes8(bvh), device=device)


@pytest.mark.parametrize("n", [6, 64])
def test_bvh8_kernels_match_plain_on_card(cuda, n):
    """K11, K12 and K13 against their plain versions (equal bit for bit)
    and against K2, K4 and K3 on the same rays. At n = 6 the root holds
    two empty slots (NaN bounds, enc 0) and the rays start inside the
    root's box, near the scene's centre."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=n, width=32,
                             height=32)
    geom, frame = sc["geom"], sc["frame"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    nodes8 = _nodes8(sc, cuda)
    R = 5000
    rng = np.random.default_rng(n)
    if n == 6:
        assert int(torch.isnan(nodes8[0, :, 0]).sum()) == 2
        lo = frame["wc_aabb_min_w"].amin(0)
        hi = frame["wc_aabb_max_w"].amax(0)
        o = (lo + hi) / 2 + torch.as_tensor(
            rng.uniform(-0.3, 0.3, (R, 3)), dtype=torch.float32, device=cuda)
        d = torch.as_tensor(rng.normal(size=(R, 3)), dtype=torch.float32,
                            device=cuda)
        o, d = o.contiguous(), (d / d.norm(dim=1, keepdim=True)).contiguous()
        t_max = torch.full((R,), float("inf"), device=cuda)
    else:
        o, d, t_max = _incoherent_rays(sc, R, 9, cuda)
    for f in tb.KERNELS:
        f.launches = 0
    got = tb.trace_closest_bvh8(geom["packed9"], nodes8, o, d, 1e-4, t_max)
    want = tb.trace_closest_bvh8_plain(geom["packed9"], nodes8, o, d, 1e-4,
                                       t_max)
    assert torch.equal(got, want) and (got[:, 1] >= 0).any()
    _rows_agree(got, tb.trace_closest_bvh(geom["packed9"], *bvh, o, d, 1e-4,
                                          t_max))
    full = tb.trace_closest_bvh8_full(geom["packed_full"], nodes8, o, d, 1e-4,
                                      t_max)
    assert torch.equal(full, tb.trace_closest_bvh8_full_plain(
        geom["packed_full"], nodes8, o, d, 1e-4, t_max))
    _rows_agree(full, tb.trace_closest_bvh_full(geom["packed_full"], *bvh, o,
                                                d, 1e-4, t_max))
    t_any = torch.where(torch.isfinite(t_max), t_max, 8.0)
    occ = tb.trace_any_bvh8(geom["packed9"], nodes8, o, d, 0.1, t_any)
    assert torch.equal(occ, tb.trace_any_bvh8_plain(geom["packed9"], nodes8,
                                                    o, d, 0.1, t_any))
    assert torch.equal(occ, tb.trace_any_bvh(geom["packed9"], *bvh, o, d,
                                             0.1, t_any))
    tb.check_stack_overflow(cuda)
    assert [f.launches for f in (tb.trace_closest_bvh8,
                                 tb.trace_closest_bvh8_full,
                                 tb.trace_any_bvh8)] == [1, 1, 1]


def test_bvh8_stack_overflow_raises_on_card(cuda):
    """A 20-level chain of 8-wide nodes whose first slot is the next node
    and whose other seven are leaves, every box around the ray: each
    level leaves 7 entries on the stack, 7 * 19 + 8 > STACK8_CAP, so the
    walk sets the overflow flag and check_stack_overflow raises."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=8, width=32,
                             height=32)
    depth = 20
    assert 7 * (depth - 1) + 8 > tb.STACK8_CAP
    nodes8 = np.zeros((depth, 8, 8), np.float32)
    nodes8[:, :, 0:3] = -100.0
    nodes8[:, :, 3:6] = 100.0
    nodes8[:, 1:, 6] = -(np.arange(7) + 1.0)
    nodes8[:-1, 0, 6] = np.arange(1, depth)
    nodes8[-1, 0, 6] = -8.0  # the last node's first slot: cluster 7
    o = torch.zeros((4, 3), device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=cuda)
    tb.trace_closest_bvh8(sc["geom"]["packed9"],
                          torch.as_tensor(nodes8, device=cuda), o, d, 1e-4,
                          float("inf"))
    with pytest.raises(RuntimeError, match="stack overflow"):
        tb.check_stack_overflow(cuda)
    tb.check_stack_overflow(cuda)  # cleared


@pytest.mark.parametrize("l_cap", [2, tw.L_CAP])
def test_walk_leaves_matches_plain_on_card(cuda, l_cap):
    """X1 against its plain version: leaves and counts equal, with l_cap
    2 so that counts pass it; dead rays and zero direction components."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    frame = sc["frame"]
    table = torch.as_tensor(tw.pack_threaded(build_bvh(
        frame["wc_aabb_min_w"].cpu().numpy(),
        frame["wc_aabb_max_w"].cpu().numpy(), max_leaf_size=1)), device=cuda)
    o, d, t_max = _incoherent_rays(sc, 3000, 4, cuda)
    d[::7, 0] = 0.0
    t_max[::5] = 0.0
    tw.walk_leaves.launches = 0
    got = tw.walk_leaves(table, o, d, t_max, l_cap)
    want = tw.walk_leaves_plain(table, o, d, t_max, l_cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) > 2 and tw.walk_leaves.launches == 1


def test_visits_kernel_matches_plain_on_card(cuda):
    """X3a against its plain version (the lockstep walk): rows and counts
    equal; rows 0-5 equal K2's on the same rays."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    geom, frame = sc["geom"], sc["frame"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    o, d, t_max = _incoherent_rays(sc, 3000, 5, cuda)
    t_max[::9] = 0.0
    got = tb.trace_closest_bvh_visits(geom["packed9"], *bvh, o, d, 1e-4, t_max)
    tb.check_stack_overflow(cuda)
    want = tb.trace_closest_bvh_visits_plain(geom["packed9"], *bvh, o, d,
                                             1e-4, t_max)
    assert torch.equal(got, want) and float(got[:, 7].max()) > 1
    k2 = tb.trace_closest_bvh(geom["packed9"], *bvh, o, d, 1e-4, t_max)
    assert torch.equal(got[:, 0:6], k2[:, 0:6])


def _mixed_rays(sc, R, seed, device):
    """R of _incoherent_rays' 2048 rays (cone, free, t_max 6 and t_max 0
    lanes), drawn in a seeded order, every ninth with t_max 0 and every
    fifth from beyond the scene's bounds pointing away from them (it
    misses the root)."""
    o, d, t_max = _incoherent_rays(sc, 2048, seed, device)
    pick = torch.as_tensor(np.random.default_rng(seed).permutation(2048)[:R],
                           device=device)
    o, d, t_max = o[pick], d[pick], t_max[pick]
    t_max[::9] = 0.0
    hi = sc["frame"]["wc_aabb_max_w"].amax(0)
    away = torch.as_tensor(
        np.random.default_rng(seed + 1).uniform(0.2, 1.0, (R, 3)),
        dtype=torch.float32, device=device)
    o[2::5] = hi + 1.0 + away[2::5]
    d[2::5] = away[2::5] / away[2::5].norm(dim=1, keepdim=True)
    return o.contiguous(), d.contiguous(), t_max.contiguous()


@pytest.mark.parametrize("R", [1, 31, 33, 1031])
def test_warp_k2_k3_match_the_walk_on_card(cuda, R):
    """K2 and K3 share each leaf's tests across the warp: K2's rows 0-5
    equal the lockstep plain walk's and X3a's (the one-thread walk) bit
    for bit, K3's occlusion its plain version's, at R = 1, 31, 33 and
    1031 (a partial last warp), with t_max 0 lanes and rays that miss
    the root."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    slabs = sc["geom"]["packed9"]
    bvh = (sc["frame"]["bvh_bounds"], sc["frame"]["bvh_meta"])
    o, d, t_max = _mixed_rays(sc, R, R, cuda)
    tb.reset_launch_counts()
    got = tb.trace_closest_bvh(slabs, *bvh, o, d, 1e-4, t_max)
    x3a = tb.trace_closest_bvh_visits(slabs, *bvh, o, d, 1e-4, t_max)
    t_any = torch.where(torch.isfinite(t_max), t_max, 8.0)
    occ = tb.trace_any_bvh(slabs, *bvh, o, d, 0.1, t_any)
    tb.check_stack_overflow(cuda)
    walk = tb.trace_closest_bvh_visits_plain(slabs, *bvh, o, d, 1e-4, t_max)
    assert torch.equal(got[:, 0:6], walk[:, 0:6])
    assert torch.equal(got[:, 0:6], x3a[:, 0:6])
    assert not got[:, 6:8].any()
    assert torch.equal(occ, tb.trace_any_bvh_plain(slabs, *bvh, o, d, 0.1,
                                                   t_any))
    away = torch.zeros(R, dtype=torch.bool, device=cuda)
    away[2::5] = True
    assert (got[away | (t_max == 0), 1] == -1).all()
    assert not occ[away | (t_max == 0)].any()
    if R > 31:
        assert (got[:, 1] >= 0).any() and occ.any()
    assert (tb.trace_closest_bvh.launches, tb.trace_any_bvh.launches) == (1, 1)


def test_warp_k2_keeps_the_walk_order_on_ties_on_card(cuda):
    """testing.make_tie_scene: one triangle copied into several lanes of
    two clusters, up and down rays alternating in each warp. K2 keeps the
    lowest copy of the cluster each ray visits first, as the plain walk
    and X3a do; K3 occludes below and not above the tie's t."""
    slabs, bounds, meta, o, d, want = (
        torch.as_tensor(a, device=cuda) for a in make_tie_scene(100))
    args = (slabs, bounds, meta, o, d, 1e-4)
    inf = torch.full((100,), float("inf"), device=cuda)
    got = tb.trace_closest_bvh(*args, inf)
    x3a = tb.trace_closest_bvh_visits(*args, inf)
    tb.check_stack_overflow(cuda)
    assert torch.equal(got[:, 1].long(), want)
    assert torch.equal(got[:, 0:6], x3a[:, 0:6])
    assert torch.equal(got[:, 0:6],
                       tb.trace_closest_bvh_visits_plain(*args, inf)[:, 0:6])
    for t_max, occluded in ((6.0, True), (4.0, False)):
        occ = tb.trace_any_bvh(slabs, bounds, meta, o, d, 0.1, t_max)
        assert bool(occ.all()) if occluded else not occ.any()
        assert torch.equal(occ, tb.trace_any_bvh_plain(
            slabs, bounds, meta, o, d, 0.1, torch.full_like(inf, t_max)))


@pytest.mark.parametrize("R", [1, 31, 33, 1031])
def test_warp_k4_matches_the_walk_on_card(cuda, R):
    """K4 on the warp walk, without and with a random skip mask, at R =
    1, 31, 33 and 1031 with t_max 0 lanes and rays that miss the root:
    rows 0-15 equal the lockstep plain walk's under the same mask through
    _full_rows; unmasked, also X3a's rows 0-3 through _full_rows (t, tri
    and the u, v the attributes are interpolated at), bit for bit."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    slabs = sc["geom"]["packed_full"]
    bvh = (sc["frame"]["bvh_bounds"], sc["frame"]["bvh_meta"])
    o, d, t_max = _mixed_rays(sc, R, R + 3, cuda)
    mask = torch.as_tensor(np.random.default_rng(R).random(64) > 0.4,
                           device=cuda)
    tb.reset_launch_counts()
    for m in (None, mask):
        got = tb.trace_closest_bvh_full(slabs, *bvh, o, d, 1e-4, t_max,
                                        skip_mask=m)
        tb.check_stack_overflow(cuda)
        walk = tb.trace_closest_bvh_visits_plain(slabs, *bvh, o, d, 1e-4,
                                                 t_max, skip_mask=m)
        assert torch.equal(got, tb._full_rows(slabs, walk))
        _rows_agree(got, tb.trace_closest_bvh_full_plain(
            slabs, *bvh, o, d, 1e-4, t_max, skip_mask=m))
        away = torch.zeros(R, dtype=torch.bool, device=cuda)
        away[2::5] = True
        assert (got[away | (t_max == 0), 1] == -1).all()
        if R > 31:
            assert (got[:, 1] >= 0).any()
    x3a = tb.trace_closest_bvh_visits(slabs, *bvh, o, d, 1e-4, t_max)
    unmasked = tb.trace_closest_bvh_full(slabs, *bvh, o, d, 1e-4, t_max)
    tb.check_stack_overflow(cuda)
    assert torch.equal(unmasked, tb._full_rows(slabs, x3a))
    tri = got[:, 1].long()
    assert mask[tri[tri >= 0] // 128].all()
    assert tb.trace_closest_bvh_full.launches == 3


def _k1_frame(form, cam, device):
    """A 33x31 frame's pixels (1023 of them: the last warp holds one pad
    lane) in the (T, 3, 256) layout, and the uniforms of K1's path tracer
    form (pcg jitter) or G-buffer form (pixel centres shifted by a TAA
    jitter of (0.3, -0.2) pixels)."""
    W, H = 33, 31
    cols = gbuffer._row_pixels(W, H, str(device))
    jitter = (torch.tensor([0.6 / W, 0.4 / H], device=device)
              if form == "gbuffer" else None)
    return cols, tb.primary_cam_vec(cam, W, H, pixel_jitter=jitter,
                                    device=device)


@pytest.mark.parametrize("form", ["pt", "gbuffer"])
def test_warp_k1_matches_the_walk_on_card(cuda, form):
    """K1 on the warp walk, both forms, on a 33x31 frame of plate-64:
    rows 0-15 equal the lockstep plain walk's and X3a's on
    raygen_plain's rays through _full_rows, bit for bit; pad lanes miss
    with t = 0."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=33,
                             height=31)
    slabs = sc["geom"]["packed_full"]
    bvh = (sc["frame"]["bvh_bounds"], sc["frame"]["bvh_meta"])
    cols, vec = _k1_frame(form, cam, cuda)
    tb.reset_launch_counts()
    got = tb.trace_primary_bvh_full(slabs, *bvh, cols, vec, 7, 0.0)
    tb.check_stack_overflow(cuda)
    o, d, t_max = tb.raygen_plain(cols, vec, 7)
    o = o.contiguous()
    walk = tb.trace_closest_bvh_visits_plain(slabs, *bvh, o, d, 0.0, t_max)
    x3a = tb.trace_closest_bvh_visits(slabs, *bvh, o, d, 0.0, t_max)
    tb.check_stack_overflow(cuda)
    assert torch.equal(x3a, walk)
    assert torch.equal(got, tb._full_rows(slabs, walk))
    _rows_agree(got, tb.trace_primary_bvh_full_plain(slabs, *bvh, cols, vec,
                                                     7, 0.0))
    assert (got[1023:, 0:2] == torch.tensor([0.0, -1.0], device=cuda)).all()
    assert (got[:1023, 1] >= 0).sum() > 100
    assert tb.trace_primary_bvh_full.launches == 1


def test_warp_k4_keeps_the_walk_order_on_ties_on_card(cuda):
    """testing.make_tie_scene with attribute rows: K4 keeps the lowest
    copy of the cluster each ray visits first, and with a mask that
    kills one cluster the other's lowest copy; rows 0-15 equal the
    lockstep plain walk's with the same mask through _full_rows."""
    slabs, bounds, meta, o, d, want = (
        torch.as_tensor(a, device=cuda) for a in make_tie_scene(100, rows=40))
    inf = torch.full((100,), float("inf"), device=cuda)
    up = torch.arange(100, device=cuda) % 2 == 0
    for live in (None, (True, False), (False, True)):
        mask = None if live is None else torch.tensor(live, device=cuda)
        got = tb.trace_closest_bvh_full(slabs, bounds, meta, o, d, 1e-4, inf,
                                        skip_mask=mask)
        tb.check_stack_overflow(cuda)
        walk = tb.trace_closest_bvh_visits_plain(slabs, bounds, meta, o, d,
                                                 1e-4, inf, skip_mask=mask)
        assert torch.equal(got, tb._full_rows(slabs, walk))
        tri = got[:, 1].long()
        if live is None:
            assert torch.equal(tri, want)
        else:  # every ray takes the live cluster's lowest copy
            assert torch.equal(tri, want[up if live[1] else ~up][0]
                               .expand(100))


@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_k1_k4_stack_overflow_raises_on_card(cuda, kernel):
    """test_stack_overflow_raises_on_card's BVH chain under K1's camera
    rays and K4's ray: the warp walk sets the overflow flag."""
    fn, (sc, cam, _) = entry(cuda, width=32, height=32)
    L = tb.STACK_CAP + 6  # internal nodes 0..L-1, leaves L..2L
    left = [i + 1 for i in range(L - 1)] + [2 * L]
    meta = torch.tensor(
        [[left[i], L + i, -1] for i in range(L)] + [[-1, -1, 0]] * (L + 1),
        dtype=torch.int32, device=cuda,
    )
    # one box around everything: every ray enters every node
    bounds = torch.tensor([[-1e3, -1e3, -1e3, 1e3, 1e3, 1e3]],
                          device=cuda).expand(2 * L + 1, 6).contiguous()
    slabs = sc["geom"]["packed_full"]
    if kernel == "K1":
        _, _, cols, _ = pt._pixel_layouts(32, 32, str(cuda))
        vec = tb.primary_cam_vec(cam, 32, 32, device=cuda)
        tb.trace_primary_bvh_full(slabs, bounds, meta, cols, vec, 0, 0.0)
    else:
        o = torch.tensor([[0.0, 0.0, -50.0]], device=cuda)
        d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda)
        tb.trace_closest_bvh_full(slabs, bounds, meta, o, d, 0.0,
                                  float("inf"))
    with pytest.raises(RuntimeError, match="stack overflow"):
        tb.check_stack_overflow(cuda)
    tb.check_stack_overflow(cuda)  # cleared


@pytest.mark.parametrize("loop", ["moller", "moller_chain"])
def test_moller_loops_match_plain_on_card(cuda, loop):
    """X2's Möller loop and X3b's chain against their plain versions over
    two blocks, 5 iterations: best and the last t equal."""
    slab, cols = bmi.block_cols(2, cuda)
    fn = bk.isect_loop_moller if loop == "moller" else bk.moller_chain_loop
    chain = bk.CHAIN_X2 if loop == "moller" else bk.CHAIN_X3B
    best, t = fn(slab, cols, 5, keep_t=True)
    want_best, want_t = bk.isect_loop_plain(bk.MOLLER, chain, slab, cols, 5,
                                            keep_t=True)
    assert torch.equal(best, want_best) and torch.equal(t, want_t)
    assert int(torch.isfinite(t).sum()) > 10


@pytest.mark.parametrize("variant", ["plucker", "plucker_pre"])
def test_plucker_loops_on_card(cuda, variant):
    """The tensor-core Plücker loops against their TF32 plain version on
    the script's block and 63 seeded ones (bench_mxu_isect.block_cols):
    best equal, no hit/miss mismatch off tf32_agreement's border, t within
    rtol 1e-5 plus the reordered sums' bound where both hit; against the
    Möller block on the script's scene (bench_mxu_isect.check) by the
    script's bar, 99.95% of pairs and t within rtol 1e-2. On other rays
    TF32's rounding of o and n in n.o can move t by more than 1e-2 where
    n.v0 - n.o cancels, so the Möller bar is the script's scene's."""
    slab, cols = bmi.block_cols(64, cuda)
    best, t = bmi.LOOPS[variant](bmi.loop_input(variant, slab), cols, 3,
                                 keep_t=True)
    want, _ = bk.isect_loop_plain(bk.PLUCKER, bk.CHAIN_X2, slab, cols, 3)
    assert torch.equal(best, want) and bool(torch.isinf(want).all())
    o = cols[:, 0:3].transpose(1, 2).reshape(-1, 3)
    d = cols[:, 3:6].transpose(1, 2).reshape(-1, 3)
    a = tf32_agreement(plucker_rows_from_slab(slab), o, d, bk.T_MIN,
                       float("inf"), t)
    assert a["mismatches"] == 0 and a["t_err_ratio"] <= 1.0, a
    assert a["hits"] > 2000
    rec = bmi.check(cuda)
    assert rec["agreement"] >= bmi.AGREEMENT and rec["t_rel_err"] <= 1e-2


def test_loop_probes_match_plain_on_card(cuda):
    """X3c-f at small counts and at the script's, on seeded inputs: equal
    to their plain versions."""
    rng = np.random.default_rng(2)
    s = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, 128),
                        dtype=torch.int32, device=cuda)
    v = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    v[2:4] = np.abs(v[2:4]) * 0.5
    v[6:8] = np.abs(v[6:8]) * 0.5
    v = torch.as_tensor(v, device=cuda)
    for n in (5, 1000):
        assert torch.equal(bk.loop_flat(s, n), bk.loop_flat_plain(s, n))
        assert torch.equal(bk.loop_nested(s, n // 4, 4),
                           bk.loop_nested_plain(s, n // 4, 4))
        assert torch.equal(bk.loop_cond(s, n), bk.loop_cond_plain(s, n))
        assert torch.equal(bk.loop_vec(v, n), bk.loop_vec_plain(v, n))
    from prosper_tpu_torch.scripts import bench_loop_overhead as blo

    for name, rec in blo.main(cuda).items():
        fn, x, counts, _ = blo.probes(cuda)[name]
        plain = {bk.loop_flat: bk.loop_flat_plain,
                 bk.loop_nested: bk.loop_nested_plain,
                 bk.loop_cond: bk.loop_cond_plain,
                 bk.loop_vec: bk.loop_vec_plain}[fn]
        assert torch.equal(rec["out"], plain(x, *counts)) and rec["ms"] > 0
