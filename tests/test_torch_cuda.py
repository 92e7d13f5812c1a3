"""The CUDA kernels against their plain PyTorch versions, and the
frames on the card against the CPU frames. Skipped where torch sees no
GPU. The card's machine has no JAX, which tests/conftest.py imports, so
there run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as chip_smoke.py states them: hit/miss and occlusion equal,
tri equal except exact t ties, t within rtol 1e-5, attributes 1e-4; the
shading kernel within rtol 1e-5 / atol 1e-6 of its plain version; the
pair-block kernel's slots equal to its plain version's; K9's rows equal
to its plain version's bit for bit, ties included; K2's rows 0-5
equal to the lockstep plain walk's and the counting K2's bit for bit,
ties included, and K1's and K4's rows 0-15 to the lockstep plain walk's
(under K4's skip mask) and the counting K2's through the attribute
interpolation, bit for bit; the 8-wide kernels, the threaded walk, the
counting K2, the Möller loops, the loop probes and ReSTIR's initial
reservoirs kernel (every column of its neighbour rows) equal to their
plain versions bit for bit; the tensor-core Plücker loops agree with their TF32 plain versions on every hit off the
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
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene
from prosper_tpu_torch.testing import (
    PAIR_LAYOUTS,
    make_pair_layout,
    make_plate_scene,
    make_tie_scene,
    tie_nodes8,
)

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
    dropping clusters: K7's list and chunk boxes (no staged slab) at C =
    16385, the first C over the limit, and K10's at 60000."""
    n = 60000
    slabs = torch.zeros((n, 9, 128), device=cuda)
    box = torch.zeros((n, 3), device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    assert tf.list_bytes(16385) > tb.MAX_SHARED >= tf.list_bytes(16384)
    with pytest.raises(ValueError, match="16385 clusters needs 286720 bytes"):
        tf.trace_any_flat(slabs[:16385], box[:16385], box[:16385], o, o + 1.0,
                          0.1, 1.0)
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
    _assert_slots_equal(got, want, any_hit)
    valid = blocks[2]
    if any_hit:
        assert (got & valid).any()
    else:
        assert (got[:, 1] >= 0).any()


def _assert_slots_equal(got, want, any_hit):
    """Every slot of K14's output, valid or not, bit for bit."""
    if any_hit:
        assert torch.equal(got, want)
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.fixture(scope="module")
def plate64_rays():
    """The plate-64 scene's slabs (with attribute rows) and 5000
    incoherent rays with t_max per ray (zeros, 6 and inf)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    _, (sc, _, _) = entry(dev, scene="plate", n_clusters=64, width=32,
                          height=32)
    return (sc["geom"]["packed_full"], *_incoherent_rays(sc, 5000, 6, dev))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("B", [1, 31, 33, 66_848])
@pytest.mark.parametrize("layout", [*PAIR_LAYOUTS, "ties"])
def test_pair_block_layouts_match_plain_on_card(cuda, plate64_rays, layout,
                                                B, any_hit):
    """K14 against its plain version, every slot bit for bit, on B blocks
    laid out by testing.make_pair_layout (all empty; live at the front;
    live between and after empty blocks; partly valid slots); 66,848 is
    the block count of a 1080p set on plate-2048. "ties": the front
    layout on testing.make_tie_scene, each ray meeting every copy of its
    leaf's triangle at one t, where K14 keeps the lowest copy (lane 9 of
    cluster 0, lane 40 of cluster 1). One launch."""
    if layout == "ties":
        slabs, _, _, o, d, _ = (torch.as_tensor(a, device=cuda)
                                for a in make_tie_scene(64))
        t_max = torch.full((64,), float("inf"), device=cuda)
        t_max[::5] = 4.0  # before the plane z = 5: no hit
        kind = "front"
    else:
        slabs, o, d, t_max = plate64_rays
        kind = layout
    blocks = [torch.as_tensor(a, device=cuda) for a in make_pair_layout(
        kind, B, slabs.shape[0], o.shape[0], seed=B)]
    t_min = 0.1 if any_hit else 1e-4
    lm.run_pairs.launches = 0
    got = lm.run_pairs(slabs, *blocks, o, d, t_min, t_max, any_hit)
    torch.cuda.synchronize()
    assert lm.run_pairs.launches == 1
    want = lm.run_pairs_plain(slabs, *blocks, o, d, t_min, t_max, any_hit)
    _assert_slots_equal(got, want, any_hit)
    hits = int(got.sum()) if any_hit else int((got[:, 1] >= 0).sum())
    assert hits == 0 if layout == "empty" else B == 1 or hits > 0
    if layout != "ties":
        return
    block_leaf, slot_ray, slot_valid = blocks
    live = slot_valid & (t_max[slot_ray.long()] > 5.0)
    if any_hit:
        assert torch.equal(got, live)
        return
    lowest = torch.where(block_leaf == 0, 9, 128 + 40).float()[:, None]
    assert torch.equal(got[:, 1][live], lowest.expand(-1, 256)[live])
    assert bool((got[:, 1][~live] == -1).all())


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
    """K9 against its plain version, bit for bit, and over every cluster
    against K2 (exact t ties may differ: K2 keeps the first-visited
    cluster's copy), on incoherent rays; with a skip mask no hit on a
    masked cluster."""
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
    assert torch.equal(got, tb.trace_closest_bvh_dense_plain(
        slabs, *bvh, o, d, 1e-4, t_max, skip_mask=mask))
    tri = got[:, 1].long()
    assert (tri >= 0).any()
    if skip:
        assert mask[tri[tri >= 0] // 128].all()
    else:
        _rows_agree(got, tb.trace_closest_bvh(slabs, *bvh, o, d, 1e-4, t_max))
        tb.check_stack_overflow(cuda)
    assert tb.trace_closest_bvh_dense.launches == 1


@pytest.mark.parametrize("skip", ["none", "keep_both", "drop_0"])
def test_dense_closest_takes_the_lowest_copy_on_ties_on_card(cuda, skip):
    """testing.make_tie_scene (one triangle copied into lanes of clusters
    0 and 1, up and down rays alternating in each warp): K9 gives every
    ray the lowest copy over the live clusters (tri 9, or 168 when the
    mask drops cluster 0), its rows its plain version's bit for bit."""
    slabs, bounds, meta, o, d, _ = (
        torch.as_tensor(a, device=cuda) for a in make_tie_scene(100))
    mask = {"none": None,
            "keep_both": torch.ones(2, dtype=torch.bool, device=cuda),
            "drop_0": torch.tensor([False, True], device=cuda)}[skip]
    args = (slabs, bounds, meta, o, d, 1e-4,
            torch.full((100,), float("inf"), device=cuda))
    got = tb.trace_closest_bvh_dense(*args, skip_mask=mask)
    assert torch.equal(got, tb.trace_closest_bvh_dense_plain(
        *args, skip_mask=mask))
    assert bool((got[:, 1] == (168 if skip == "drop_0" else 9)).all())
    assert bool((got[:, 0] == 5.0).all())


def test_dense_closest_misses_when_the_mask_drops_every_cluster_on_card(
        cuda):
    """K9 with a skip mask that keeps no cluster: every ray misses, t =
    its t_max and tri = -1, as the plain version gives."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    frame, slabs = sc["frame"], sc["geom"]["packed9"]
    o, d, t_max = _incoherent_rays(sc, 1031, 5, cuda)
    args = (slabs, frame["bvh_bounds"], frame["bvh_meta"], o, d, 1e-4,
            t_max)
    none = torch.zeros(64, dtype=torch.bool, device=cuda)
    got = tb.trace_closest_bvh_dense(*args, skip_mask=none)
    assert torch.equal(got, tb.trace_closest_bvh_dense_plain(
        *args, skip_mask=none))
    assert torch.equal(got[:, 0], t_max) and bool((got[:, 1] == -1).all())
    assert bool((tb.trace_closest_bvh_dense(*args)[:, 1] >= 0).any())


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


@pytest.mark.parametrize("t_max", [float("inf"), 5.0])
def test_bvh8_closest_takes_the_lowest_copy_on_ties_on_card(cuda, t_max):
    """testing.make_tie_scene with attribute rows under testing.tie_nodes8
    (one triangle copied into lanes of clusters 0 and 1, up and down rays
    alternating in each warp, 100 rays: the last block's lanes past R take
    part in the warp walk): K11 and K12 give every ray the lowest copy over
    both clusters, tri 9 at t = 5, or a miss at t_max = 5; their rows,
    attributes included, equal their plain versions' bit for bit."""
    slabs, bounds, meta, o, d, _ = make_tie_scene(100, rows=40)
    nodes8 = tie_nodes8(bounds, meta)
    slabs, nodes8, o, d = (torch.as_tensor(a, device=cuda)
                           for a in (slabs, nodes8, o, d))
    args = (slabs, nodes8, o, d, 1e-4,
            torch.full((100,), t_max, device=cuda))
    got = tb.trace_closest_bvh8(*args)
    full = tb.trace_closest_bvh8_full(*args)
    tb.check_stack_overflow(cuda)
    assert torch.equal(got, tb.trace_closest_bvh8_plain(*args))
    assert torch.equal(full, tb.trace_closest_bvh8_full_plain(*args))
    hit = t_max > 5.0
    assert bool((got[:, 1] == (9 if hit else -1)).all())
    assert bool((got[:, 0] == (5.0 if hit else t_max)).all())


@pytest.mark.parametrize("t_max", [float("inf"), 5.0])
def test_bvh8_any_on_ties_on_card(cuda, t_max):
    """K13 on testing.make_tie_scene under testing.tie_nodes8 (100 rays:
    the last block's lanes past R take part in the warp walk): every ray
    meets the copies at t = 5, so every ray is occluded at t_max inf and
    none at t_max 5 (t = 5 is not below it); the occlusion equals the
    plain version's and K3's on the BVH2 tree."""
    slabs, bounds, meta, o, d, _ = make_tie_scene(100)
    nodes8 = tie_nodes8(bounds, meta)
    slabs, bounds, meta, nodes8, o, d = (
        torch.as_tensor(a, device=cuda)
        for a in (slabs, bounds, meta, nodes8, o, d))
    t = torch.full((100,), t_max, device=cuda)
    occ = tb.trace_any_bvh8(slabs, nodes8, o, d, 0.1, t)
    tb.check_stack_overflow(cuda)
    assert bool((occ == (t_max > 5.0)).all())
    assert torch.equal(occ, tb.trace_any_bvh8_plain(slabs, nodes8, o, d, 0.1,
                                                    t))
    assert torch.equal(occ, tb.trace_any_bvh(slabs, bounds, meta, o, d, 0.1,
                                             t))


@pytest.mark.parametrize("kernel", ["K11", "K13"])
def test_bvh8_stack_overflow_raises_on_card(cuda, kernel):
    """A 20-level chain of 8-wide nodes whose first slot is the next node
    and whose other seven are leaves, every box around the ray: each
    level leaves 7 entries on the stack, 7 * 19 + 8 > STACK8_CAP, so the
    walk sets the overflow flag and check_stack_overflow raises. K13's
    slabs hold triangles off the rays, so no hit ends its walk early."""
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
    nodes8 = torch.as_tensor(nodes8, device=cuda)
    if kernel == "K11":
        tb.trace_closest_bvh8(sc["geom"]["packed9"], nodes8, o, d, 1e-4,
                              float("inf"))
    else:
        misses = torch.zeros((8, 9, 128), device=cuda)
        misses[:, 0:3] = 50.0  # v0 off the rays (x = y = 0)
        misses[:, 3] = misses[:, 7] = 1.0  # e1 = x, e2 = y
        occ = tb.trace_any_bvh8(misses, nodes8, o, d, 0.1, float("inf"))
        assert not bool(occ.any())
    with pytest.raises(RuntimeError, match="stack overflow"):
        tb.check_stack_overflow(cuda)
    tb.check_stack_overflow(cuda)  # cleared


def _walk_table(sc, device):
    """The threaded table of the scene's cluster AABBs."""
    frame = sc["frame"]
    return torch.as_tensor(tw.pack_threaded(build_bvh(
        frame["wc_aabb_min_w"].cpu().numpy(),
        frame["wc_aabb_max_w"].cpu().numpy(), max_leaf_size=1)),
        device=device)


@pytest.mark.parametrize("l_cap", [2, tw.L_CAP])
def test_walk_leaves_matches_plain_on_card(cuda, l_cap):
    """X1 against its plain version: leaves and counts equal, with l_cap
    2 so that counts pass it; dead rays and zero direction components."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    table = _walk_table(sc, cuda)
    o, d, t_max = _incoherent_rays(sc, 3000, 4, cuda)
    d[::7, 0] = 0.0
    t_max[::5] = 0.0
    tw.walk_leaves.launches = 0
    got = tw.walk_leaves(table, o, d, t_max, l_cap)
    want = tw.walk_leaves_plain(table, o, d, t_max, l_cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) > 2 and tw.walk_leaves.launches == 1


@pytest.mark.parametrize("l_cap", [1, 5, 32])
@pytest.mark.parametrize("n_clusters,path", [(64, "shared"),
                                             (8192, "global")])
def test_walk_leaves_paths_match_plain_on_card(cuda, n_clusters, path,
                                               l_cap):
    """X1 from shared memory (plate-64, 1 chunk) and from its node-major
    copy in device memory (plate-8192, 128 chunks, over a block's shared
    memory) against the plain walk: leaves and counts equal, at l_cap 1,
    5 (rows that share 16-byte groups) and 32, with dead rays, zero
    direction components and 3001 rays (not a multiple of the block)."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=n_clusters,
                             width=32, height=32)
    table = _walk_table(sc, cuda)
    assert tw.walk_path(table.shape[0]) == path
    o, d, t_max = _incoherent_rays(sc, 3001, 4, cuda)
    d[::7, 0] = 0.0
    t_max[::5] = 0.0
    tw.walk_leaves.launches = 0
    got = tw.walk_leaves(table, o, d, t_max, l_cap)
    want = tw.walk_leaves_plain(table, o, d, t_max, l_cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) > min(l_cap, 5)  # plate-8192 passes 32
    assert tw.walk_leaves.launches == 1
    assert bool((got[1][t_max == 0] == 0).all())


@pytest.mark.parametrize("n_boxes,path", [(3584, "shared"),
                                          (3585, "global")])
def test_walk_leaves_at_the_shared_memory_limit_on_card(cuda, n_boxes,
                                                        path):
    """Tables of 56 chunks (229,376 bytes node-major, the most a block's
    shared memory takes) and 57 (the first over it) walked by 140,001
    rays, more than the persistent blocks hold at once, so each thread
    walks several: leaves and counts equal the plain walk's."""
    rng = np.random.default_rng(n_boxes)
    c = rng.uniform(-1, 1, (n_boxes, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.08, (n_boxes, 3)).astype(np.float32)
    table = torch.as_tensor(tw.pack_threaded(build_bvh(
        c - h, c + h, max_leaf_size=1)), device=cuda)
    assert table.shape[0] == 56 + (path == "global")
    assert tw.walk_path(table.shape[0]) == path
    R = 140_001
    o = torch.as_tensor(rng.uniform(-1.5, 1.5, (R, 3)), dtype=torch.float32,
                        device=cuda)
    d = torch.as_tensor(rng.normal(size=(R, 3)), dtype=torch.float32,
                        device=cuda)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    t_max = torch.full((R,), float("inf"), device=cuda)
    t_max[::9] = 0.0
    t_max[1::7] = 0.5
    got = tw.walk_leaves(table, o, d, t_max, 7)
    want = tw.walk_leaves_plain(table, o, d, t_max, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) > 7


@pytest.mark.parametrize("m", [0, 1, 7, 50_000])
@pytest.mark.parametrize("k", [0, 1, 3, 4, 5])
def test_loop_nested_instances_match_plain_on_card(cuda, k, m):
    """X3d's generic instance (k read at run time) at every k, and the
    compile-time instance at k = 4, on the script's s and a seeded one:
    equal to the plain version; the compile-time instance refuses any
    other k."""
    rng = np.random.default_rng(k * 100 + m % 97)
    seeded = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, 128),
                             dtype=torch.int32, device=cuda)
    script = torch.arange(128, dtype=torch.int32, device=cuda)
    instances = (0, bk.K_STATIC) if k == bk.K_STATIC else (0,)
    bk.loop_nested.launches = 0
    for s in (script, seeded):
        want = bk.loop_nested_plain(s, m, k)
        for kt in instances:
            assert torch.equal(bk.loop_nested(s, m, k, kt), want), (kt, s[0])
    assert bk.loop_nested.launches == 2 * len(instances)
    if k != bk.K_STATIC:
        with pytest.raises(ValueError, match="no instance"):
            bk.loop_nested(script, m, k, bk.K_STATIC)


def test_loop_nested_takes_twice_the_time_at_twice_the_entries_on_card(
        cuda):
    """Each X3d instance at 2 M outer iterations (the script's M = 50,000,
    K = 4) takes at least 1.8x its time at M: no entry is folded away."""
    s = torch.arange(128, dtype=torch.int32, device=cuda)
    m = 50_000
    for kt in (bk.K_STATIC, 0):
        ms = {n: bk.event_ms(lambda: bk.loop_nested(s, n, 4, kt), 5)
              for n in (m, 2 * m)}
        assert ms[2 * m] / ms[m] >= 1.8, (kt, ms)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               200_000, 200_001])
def test_loop_flat_matches_plain_on_card(cuda, n):
    """X3c at counts around its 64-iteration runs and the 128-entry
    window, and at the script's N = 200,000: equal to its plain version
    on the script's s and a seeded one."""
    rng = np.random.default_rng(n % 997)
    seeded = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, 128),
                             dtype=torch.int32, device=cuda)
    script = torch.arange(128, dtype=torch.int32, device=cuda)
    bk.loop_flat.launches = 0
    for s in (script, seeded):
        assert torch.equal(bk.loop_flat(s, n), bk.loop_flat_plain(s, n))
    assert bk.loop_flat.launches == 2


def test_loop_flat_takes_twice_the_time_at_twice_the_iterations_on_card(
        cuda):
    """X3c at 2 N iterations (the script's N = 200,000) takes at least
    1.8x its time at N: no iteration is folded away."""
    s = torch.arange(128, dtype=torch.int32, device=cuda)
    n = 200_000
    ms = {k: bk.event_ms(lambda: bk.loop_flat(s, k), 5) for k in (n, 2 * n)}
    assert ms[2 * n] / ms[n] >= 1.8, ms


_KT = bk.COND_RUN


@pytest.mark.parametrize("n", sorted({0, 1, 3, 4, 5, 128, _KT - 1, _KT,
                                      _KT + 1, 2 * _KT - 1, 2 * _KT + 1,
                                      200_000}))
def test_loop_cond_matches_plain_on_card(cuda, n):
    """X3e at counts around its COND_RUN-iteration runs and at the
    script's N = 200,000: equal to its plain version on the script's s
    and a seeded one."""
    rng = np.random.default_rng(n % 991)
    seeded = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, 128),
                             dtype=torch.int32, device=cuda)
    script = torch.arange(128, dtype=torch.int32, device=cuda)
    bk.loop_cond.launches = 0
    for s in (script, seeded):
        assert torch.equal(bk.loop_cond(s, n), bk.loop_cond_plain(s, n))
    assert bk.loop_cond.launches == 2


def test_loop_cond_takes_twice_the_time_at_twice_the_iterations_on_card(
        cuda):
    """X3e at 2 N iterations (the script's N = 200,000) takes at least
    1.8x its time at N: no iteration is folded away."""
    s = torch.arange(128, dtype=torch.int32, device=cuda)
    n = 200_000
    ms = {k: bk.event_ms(lambda: bk.loop_cond(s, k), 5) for k in (n, 2 * n)}
    assert ms[2 * n] / ms[n] >= 1.8, ms


@pytest.mark.parametrize("R", [1, 31, 33, 3000])
def test_visits_kernel_matches_plain_on_card(cuda, R):
    """X3a (K2's warp walk counting each lane's nodes and leaves) against
    its plain version (the lockstep walk) at R = 1, 31, 33 (a partial
    last warp, _mixed_rays' lanes) and on 3000 incoherent rays: rows and
    counts equal; rows 0-5 equal K2's on the same rays."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    geom, frame = sc["geom"], sc["frame"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    if R == 3000:
        o, d, t_max = _incoherent_rays(sc, 3000, 5, cuda)
        t_max[::9] = 0.0
    else:
        o, d, t_max = _mixed_rays(sc, R, R + 7, cuda)
    got = tb.trace_closest_bvh_visits(geom["packed9"], *bvh, o, d, 1e-4, t_max)
    tb.check_stack_overflow(cuda)
    want = tb.trace_closest_bvh_visits_plain(geom["packed9"], *bvh, o, d,
                                             1e-4, t_max)
    assert torch.equal(got, want)
    if R > 31:
        assert float(got[:, 7].max()) > 1
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
    equal the lockstep plain walk's bit for bit, and X3a's (K2 counting
    its walk, which must leave the rows alone), K3's occlusion its plain
    version's, at R = 1, 31, 33 and 1031 (a partial last warp), with
    t_max 0 lanes and rays that miss the root."""
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
    does; X3a's rows and counts equal the plain walk's; K3 occludes below
    and not above the tie's t."""
    slabs, bounds, meta, o, d, want = (
        torch.as_tensor(a, device=cuda) for a in make_tie_scene(100))
    args = (slabs, bounds, meta, o, d, 1e-4)
    inf = torch.full((100,), float("inf"), device=cuda)
    got = tb.trace_closest_bvh(*args, inf)
    x3a = tb.trace_closest_bvh_visits(*args, inf)
    tb.check_stack_overflow(cuda)
    walk = tb.trace_closest_bvh_visits_plain(*args, inf)
    assert torch.equal(got[:, 1].long(), want)
    assert torch.equal(got[:, 0:6], walk[:, 0:6])
    assert torch.equal(x3a, walk) and float(x3a[:, 7].min()) >= 1
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
    _full_rows (t, tri and the u, v the attributes are interpolated at),
    bit for bit."""
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
    tri = got[:, 1].long()
    assert mask[tri[tri >= 0] // 128].all()
    assert tb.trace_closest_bvh_full.launches == 2


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
    rows 0-15 equal the lockstep plain walk's on raygen_plain's rays
    through _full_rows, bit for bit; pad lanes miss with t = 0."""
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


@pytest.mark.parametrize("iters", [1, 2, 33])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e6])
def test_x3b_chain_loop_matches_plain_on_card(cuda, scale, iters):
    """X3b's chain on X2's Möller loop (four lanes a ray, rcp_normal):
    best and the last t equal the plain version's bit for bit over eight
    blocks, at 1 iteration (the last, storing, one alone), 2 and 33, with
    the scene and its rays scaled by 1e-3, 1 and 1e6 (det spans binades
    from about 1e-7 to 1e12)."""
    slab, cols = bmi.block_cols(8, cuda)
    slab = slab * scale
    cols = cols.clone()
    cols[:, 0:3] *= scale
    best, t = bk.moller_chain_loop(slab, cols, iters, keep_t=True)
    want_best, want_t = bk.isect_loop_plain(bk.MOLLER, bk.CHAIN_X3B, slab,
                                            cols, iters, keep_t=True)
    assert torch.equal(best, want_best) and torch.equal(t, want_t)
    assert int(torch.isfinite(best).sum()) > 100


def test_x3b_chain_loop_takes_twice_the_time_at_twice_the_iterations_on_card(
        cuda):
    """X3b's best stops changing after its first iteration, but every
    iteration's tests take the previous one's best as t_upper: at 2 K
    iterations one block and 1056 blocks take at least 1.8x their time at
    K, so no iteration is hoisted or skipped."""
    for blocks, k in ((1, 1024), (1056, 32)):
        slab, cols = bmi.block_cols(blocks, cuda)
        ms = {n: bk.event_ms(lambda: bk.moller_chain_loop(slab, cols, n))
              for n in (k, 2 * k)}
        assert ms[2 * k] / ms[k] >= 1.8, (blocks, ms)


@pytest.mark.parametrize("scale", [1e-3, 1e3, 1e6])
def test_x2_moller_loop_matches_plain_across_scales_on_card(cuda, scale):
    """X2's Möller loop takes 1 / det from rcp_normal (no branch), IEEE
    division's value for a normal |det| < 2^126: with the scene and its
    rays scaled by 1e-3, 1e3 and 1e6, det spans binades from about 1e-7
    to 1e12, and best and the last t still equal the plain version's bit
    for bit over eight blocks."""
    slab, cols = bmi.block_cols(8, cuda)
    slab = slab * scale
    cols = cols.clone()
    cols[:, 0:3] *= scale
    best, t = bk.isect_loop_moller(slab, cols, 2, keep_t=True)
    want_best, want_t = bk.isect_loop_plain(bk.MOLLER, bk.CHAIN_X2, slab,
                                            cols, 2, keep_t=True)
    assert torch.equal(best, want_best) and torch.equal(t, want_t)
    assert int(torch.isfinite(t).sum()) > 100


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


def _shade_inputs(width, height, n_point, n_spot, seed, device, far_head=0,
                  empty_tile=False):
    """Synthetic K5 inputs, the camera at the origin looking down -z (view
    space is world space): per pixel a random view depth in [0.3, 60] of
    [0.1, 100], so the lanes of a warp sit in different Doom slices; a
    normal towards the camera; every seventh pixel, and tile 0 wholly if
    empty_tile, without a surface. n_point point lights with radii in
    [0.05, 4] at depths in [0.2, 60], but the first far_head at [85,
    99], where no pixel's slice sees them; n_spot spot lights; each tile lists a random subset of the point lights (tile 1 all, tile 2
    none) in ascending order, then the others."""
    rng = np.random.default_rng(seed)
    R = width * height
    depth = rng.uniform(0.3, 60.0, R)
    pos = np.stack([rng.uniform(-1, 1, R) * depth * 0.5,
                    rng.uniform(-1, 1, R) * depth * 0.3, -depth])
    nrm = rng.normal(size=(3, R))
    nrm[2] = np.abs(nrm[2]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=0)
    valid = np.arange(R) % 7 != 3
    fx, fy = tst.tile_grid(width, height)
    tile = (np.arange(R) // width // 32) * fx + np.arange(R) % width // 32
    if empty_tile:
        valid &= tile != 0
    chan = np.concatenate([
        pos, nrm, rng.uniform(0.1, 0.9, (3, R)), rng.uniform(0.2, 1.0, (1, R)),
        rng.uniform(0.0, 1.0, (1, R)), -depth[None], valid[None]])
    lcap = -(-n_point // 128) * 128
    rows = np.zeros((1 + lcap + n_spot, 12))
    lz = np.where(np.arange(n_point) < far_head,
                  rng.uniform(85.0, 99.0, n_point),
                  rng.uniform(0.2, 60.0, n_point))
    rows[1:1 + n_point, 1:4] = rng.uniform(0.5, 5.0, (n_point, 3))
    rows[1:1 + n_point, 4] = rng.uniform(-20, 20, n_point)
    rows[1:1 + n_point, 5] = rng.uniform(-10, 10, n_point)
    rows[1:1 + n_point, 6] = -lz
    rows[1:1 + n_point, 7] = rng.uniform(0.05, 4.0, n_point)
    spots = slice(1 + n_point, 1 + n_point + n_spot)
    rows[spots, 1:4] = rng.uniform(0.5, 5.0, (n_spot, 3))
    rows[spots, 4:7] = rng.uniform(-5, 5, (n_spot, 3)) + [0, 0, 10]
    sd = rng.normal(size=(n_spot, 3)) + [0, 0, -2]
    rows[spots, 8:11] = sd / np.linalg.norm(sd, axis=1, keepdims=True)
    rows[spots, 7] = rng.uniform(1.0, 4.0, n_spot)
    rows[spots, 11] = rng.uniform(-1.0, 0.5, n_spot)
    lists = np.zeros((fx * fy, lcap), np.int32)
    counts = rng.integers(0, n_point + 1, fx * fy)
    counts[1 % (fx * fy)] = n_point
    if fx * fy > 2:
        counts[2] = 0
    for t in range(fx * fy):
        keep = np.sort(rng.choice(n_point, counts[t], replace=False))
        rest = np.setdiff1d(np.arange(n_point), keep)
        lists[t, :n_point] = np.concatenate([keep, rest])
    lvz = np.zeros(lcap)
    lvz[:n_point] = -lz
    scal = [0.1, 100.0, np.log(1000.0), 0, 0, 0, 0, 0]
    inp = {"chan": chan, "rows": rows, "lists": lists, "counts": counts,
           "lvz": lvz, "ints": [n_point, min(n_spot, 128)], "scal": scal}
    return {k: torch.as_tensor(np.asarray(v), device=device,
                               dtype=torch.int32 if k in ("lists", "counts",
                                                          "ints")
                               else torch.float32).contiguous()
            for k, v in inp.items()}


@pytest.mark.parametrize("case", [
    "straddle", "long_list", "empty_tile_many_spots", "ragged_few_spots"])
def test_shade_warp_exit_matches_plain_on_card(cuda, case):
    """K5 and its walk form against their plain versions on synthetic
    G-buffers: lanes of one warp reach their 128th visible light at
    different list entries (straddle); a list longer than one staging
    pass, some pixels reaching 128 only in the second (long_list); a
    tile without a surface and 150 spot lights, of which 128 shade
    (empty_tile_many_spots); a 33x31 frame of one ragged tile with 3
    spot lights. K5 within rtol 1e-5 / atol 1e-6, the walk form
    exactly."""
    W, H, n_point, n_spot, far_head, empty = {
        "straddle": (70, 45, 1024, 0, 0, False),
        "long_list": (40, 20, 8000, 0, 7000, False),
        "empty_tile_many_spots": (70, 45, 300, 150, 0, True),
        "ragged_few_spots": (33, 31, 200, 3, 0, False),
    }[case]
    inp = _shade_inputs(W, H, n_point, n_spot, 17, cuda, far_head, empty)
    tst.shade_clustered_tiles.launches = tst.shade_walk_counts.launches = 0
    got = tst.shade_clustered_tiles(inp, W, H)
    walk = tst.shade_walk_counts(inp, W, H)
    torch.cuda.synchronize()
    want, cnt, needed = tst.shade_clustered_tiles_plain(inp, W, H,
                                                        return_counts=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(walk, tst.shade_walk_counts_plain(inp, W, H))
    assert (tst.shade_clustered_tiles.launches,
            tst.shade_walk_counts.launches) == (1, 1)
    valid = inp["chan"][12] > 0
    assert (got[valid] > 0).any() and (got[~valid] == 0).all()
    full = valid & (cnt >= 128)
    if case == "straddle":
        # warps whose lanes reach 128 at different entries, and warps
        # that walk past some lane's 128th visible light
        assert int(full.sum()) > 100
        assert bool((walk[full, 1] > needed[full]).any())
        assert bool((walk[full, 2] > 128).any())
    if case == "long_list":
        assert int(inp["lists"].shape[1]) > tst.MAX_STAGE
        assert bool((full & (needed > tst.MAX_STAGE)).any())
        assert bool((valid & (cnt < 128)).any())
    if case == "empty_tile_many_spots":
        assert int(inp["ints"][1]) == 128
        assert bool((got[:32 * W][valid[:32 * W]] > 0).any())


@pytest.mark.parametrize("skip", [False, True], ids=["all", "skip_mask"])
def test_dense_any_warp_walk_matches_plain_on_card(cuda, skip):
    """K10's warp-shared walk against its plain version and K3 on 1031
    incoherent rays (a short last packet, whose lanes enter different
    clusters), every ninth lane at t_max 0 and every eleventh at t_max =
    t_min; K10's cull form against its plain version; K9's rows on the
    same rays equal to its plain version's."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    frame, slabs = sc["frame"], sc["geom"]["packed9"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    o, d, t_max = _incoherent_rays(sc, 1031, 11, cuda)
    t_max[::11] = 0.1
    mask = None
    if skip:
        mask = torch.as_tensor(np.random.default_rng(7).random(64) > 0.4,
                               device=cuda)
    args = (slabs, *bvh, o, d, 0.1, t_max)
    for f in (tb.trace_any_bvh_dense, tb.dense_cull_counts,
              tb.trace_closest_bvh_dense):
        f.launches = 0
    got = tb.trace_any_bvh_dense(*args, skip_mask=mask)
    counts = tb.dense_cull_counts(*args, skip_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got, tb.trace_any_bvh_dense_plain(*args,
                                                         skip_mask=mask))
    assert not got[t_max <= 0.1].any() and got.any() and not got.all()
    k3 = tb.trace_any_bvh(*args)
    tb.check_stack_overflow(cuda)
    if skip:
        assert bool((got <= k3).all()) and not torch.equal(got, k3)
    else:
        assert torch.equal(got, k3)
    assert torch.equal(counts, tb.dense_cull_counts_plain(*args,
                                                          skip_mask=mask))
    assert counts.shape == (9,) and bool((counts > 1).all())
    rows = tb.trace_closest_bvh_dense(slabs, *bvh, o, d, 1e-4, t_max,
                                      skip_mask=mask)
    want = tb.trace_closest_bvh_dense_plain(slabs, *bvh, o, d, 1e-4, t_max,
                                            skip_mask=mask)
    assert torch.equal(rows[:, :4], want[:, :4])
    assert (tb.trace_any_bvh_dense.launches, tb.dense_cull_counts.launches,
            tb.trace_closest_bvh_dense.launches) == (1, 1, 1)


def _flat_pair(full):
    return ((tf.trace_closest_flat_full, tf.trace_closest_flat_full_plain)
            if full else (tf.trace_closest_flat, tf.trace_closest_flat_plain))


@pytest.mark.parametrize("full", [False, True], ids=["K6", "K8"])
@pytest.mark.parametrize("R", [1, 31, 33, 1031])
def test_warp_flat_walk_matches_plain_on_card(cuda, R, full):
    """K6 and K8 walk the tile's list warp by warp: rows equal their
    plain versions' bit for bit at R = 1, 31, 33 and 1031 (a partial last
    warp and tile; C = 64, not a multiple of 256), over the cluster
    AABBs and masked ones, with t_max 0 and t_max = t_min lanes among
    live ones, rays that miss every box, and (R = 1031) a first tile
    whose t_max are all <= t_min."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32, blend_every=8, mask_every=8)
    kern, plain = _flat_pair(full)
    slabs = sc["geom"]["packed_full" if full else "packed9"]
    frame = sc["frame"]
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    keep = torch.as_tensor(np.random.default_rng(R).random(64) > 0.3,
                           device=cuda)
    o, d, t_max = _mixed_rays(sc, R, R, cuda)
    t_max[1::11] = 1e-4  # = t_min: no hit
    if R > 256:
        t_max[:256] = torch.where(t_max[:256] > 1e-4, 1e-4, t_max[:256])
    kern.launches = 0
    for bmin, bmax in ((mn, mx), gbuffer._masked_aabbs(mn, mx, keep)):
        got = kern(slabs, bmin, bmax, o, d, 1e-4, t_max)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(slabs, bmin, bmax, o, d, 1e-4, t_max))
        assert (got[t_max <= 1e-4, 1] == -1).all()
        if R > 256:
            assert (got[:256, 1] == -1).all()
        if R > 31:
            assert (got[:, 1] >= 0).any()
    assert kern.launches == 2


@pytest.mark.parametrize("full", [False, True], ids=["K6", "K8"])
@pytest.mark.parametrize("rays", ["up", "down", "mixed"])
def test_warp_flat_walk_takes_the_lowest_tri_on_ties_on_card(cuda, rays,
                                                             full):
    """testing.make_tie_scene over its two leaf boxes: an up ray's tile
    lists cluster 1 (copies from tri 168) first, yet K6 and K8 give tri 9,
    the lowest copy over all clusters, to every ray, with K8's attributes
    those of tri 9: rows equal the plain versions' bit for bit (the warp
    walk of K2 and K4 keeps the earlier visit, 168)."""
    slabs, bounds, meta, o, d, _ = make_tie_scene(64, rows=40 if full else 9)
    pick = {"up": slice(0, None, 2), "down": slice(1, None, 2),
            "mixed": slice(None)}[rays]
    slabs, bounds, meta = (torch.as_tensor(a, device=cuda)
                           for a in (slabs, bounds, meta))
    o, d = (torch.as_tensor(a[pick], device=cuda).contiguous()
            for a in (o, d))
    mn, mx = (b.contiguous() for b in tb._leaf_boxes(bounds, meta, 2))
    kern, plain = _flat_pair(full)
    inf = torch.full((o.shape[0],), float("inf"), device=cuda)
    got = kern(slabs, mn, mx, o, d, 1e-4, inf)
    torch.cuda.synchronize()
    assert (got[:, 1] == 9).all()
    assert torch.equal(got, plain(slabs, mn, mx, o, d, 1e-4, inf))


@pytest.mark.parametrize("full", [False, True], ids=["K6", "K8"])
def test_flat_walk_near_the_list_limit_on_card(cuda, full):
    """C = 16381 (the list's power of two, 16384, is the most a block's
    shared memory holds; C not a multiple of 256): plate-64's clusters
    repeated, so each triangle has 256 copies at the same t and the tie
    goes to the lowest id. Rows equal the plain version's bit for bit;
    C = 16385 is refused."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    kern, plain = _flat_pair(full)
    slabs = sc["geom"]["packed_full" if full else "packed9"]
    frame = sc["frame"]
    C = 16381
    big = slabs.repeat(256, 1, 1)[:C].contiguous()
    mn = frame["wc_aabb_min_w"].repeat(256, 1)[:C].contiguous()
    mx = frame["wc_aabb_max_w"].repeat(256, 1)[:C].contiguous()
    o, d, t_max = _mixed_rays(sc, 1031, 3, cuda)
    got = kern(big, mn, mx, o, d, 1e-4, t_max)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(big, mn, mx, o, d, 1e-4, t_max))
    hit = got[:, 1] >= 0
    assert hit.any() and (got[hit, 1] < 64 * 128).all()
    assert torch.equal(got, plain(slabs, frame["wc_aabb_min_w"],
                                  frame["wc_aabb_max_w"], o, d, 1e-4, t_max))
    over = torch.cat([big, slabs[:4]])
    with pytest.raises(ValueError, match="shared memory"):
        kern(over, torch.cat([mn, mn[:4]]), torch.cat([mx, mx[:4]]), o, d,
             1e-4, t_max)


@pytest.mark.parametrize("R", [1, 31, 33, 1031])
def test_warp_flat_any_walk_matches_plain_and_k3_on_card(cuda, R):
    """K7 walks the tile's list warp by warp under the chunk boxes: the
    mask equals its plain version's bit for bit at R = 1, 31, 33 and 1031
    (a partial last warp and tile), over the cluster AABBs and masked
    ones, with t_max 0 and t_max = t_min lanes among live ones (never
    occluded), rays that miss every box and (R = 1031) a first tile whose
    t_max are all <= t_min; over the unmasked AABBs it equals K3 on the
    same rays, over masked ones it is a subset of K3's."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    slabs, frame = sc["geom"]["packed9"], sc["frame"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    mn, mx = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    keep = torch.as_tensor(np.random.default_rng(R).random(64) > 0.3,
                           device=cuda)
    o, d, t_max = _mixed_rays(sc, R, R, cuda)
    t_max[1::11] = 0.1  # = t_min: no hit
    if R > 256:
        t_max[:256] = torch.where(t_max[:256] > 0.1, 0.1, t_max[:256])
    k3 = tb.trace_any_bvh(slabs, *bvh, o, d, 0.1, t_max)
    tb.check_stack_overflow(cuda)
    tf.trace_any_flat.launches = 0
    for masked in (False, True):
        bmin, bmax = (gbuffer._masked_aabbs(mn, mx, keep) if masked
                      else (mn, mx))
        got = tf.trace_any_flat(slabs, bmin, bmax, o, d, 0.1, t_max)
        torch.cuda.synchronize()
        assert torch.equal(got, tf.trace_any_flat_plain(slabs, bmin, bmax, o,
                                                        d, 0.1, t_max))
        assert not got[t_max <= 0.1].any()
        if R > 256:
            assert not got[:256].any()
        if masked:
            assert bool((got <= k3).all())
        else:
            assert torch.equal(got, k3)
    if R > 31:
        assert k3.any() and not k3.all()
    assert tf.trace_any_flat.launches == 2


def test_flat_any_walk_finds_an_occluder_in_the_last_chunk_on_card(cuda):
    """A tile lists 100 clusters whose AABBs every ray enters; only the
    last, in the last chunk (entries 96-99), holds an occluder (a square
    at z = 0), the others triangles far off every ray. K7's mask equals
    its plain version's and the mask of the last cluster alone, bit for
    bit, at R = 1031 with t_max <= t_min lanes."""
    C = 100
    rng = np.random.default_rng(7)
    slabs = np.zeros((C, 9, 128), np.float32)
    slabs[:, 0:3] = 100.0 + rng.random((C, 3, 128), dtype=np.float32)
    slabs[:, 3:6] = rng.uniform(-0.5, 0.5, (C, 3, 128)).astype(np.float32)
    slabs[:, 6:9] = rng.uniform(-0.5, 0.5, (C, 3, 128)).astype(np.float32)
    # cluster C - 1, lanes 0 and 1: the square [-1, 1]^2 at z = 0
    for lane, (v0, e1, e2) in enumerate((
            ((-1, -1, 0), (2, 0, 0), (0, 2, 0)),
            ((1, 1, 0), (-2, 0, 0), (0, -2, 0)))):
        slabs[C - 1, 0:3, lane] = v0
        slabs[C - 1, 3:6, lane] = e1
        slabs[C - 1, 6:9, lane] = e2
    mn = np.full((C, 3), -10.0, np.float32)
    mx = np.full((C, 3), 10.0, np.float32)
    mn[C - 1], mx[C - 1] = (-1.0, -1.0, -0.01), (1.0, 1.0, 0.01)
    R = 1031
    o = np.zeros((R, 3), np.float32)
    o[:, 0:2] = rng.uniform(-2.0, 2.0, (R, 2))
    o[:, 2] = -5.0
    d = np.zeros((R, 3), np.float32)
    d[:, 0:2] = rng.uniform(-0.05, 0.05, (R, 2))
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((R,), 8.0, np.float32)
    t_max[3::13] = 0.1
    slabs, mn, mx, o, d, t_max = (torch.as_tensor(a, device=cuda)
                                  for a in (slabs, mn, mx, o, d, t_max))
    got = tf.trace_any_flat(slabs, mn, mx, o, d, 0.1, t_max)
    torch.cuda.synchronize()
    assert torch.equal(got, tf.trace_any_flat_plain(slabs, mn, mx, o, d, 0.1,
                                                    t_max))
    last = tf.trace_any_flat(slabs[C - 1:].contiguous(), mn[C - 1:],
                             mx[C - 1:], o, d, 0.1, t_max)
    assert torch.equal(got, last)
    assert got.sum() > 100 and not got.all()
    assert not got[t_max <= 0.1].any()
    lists, counts, _ = tf.cull_lists(o, d, 0.1, t_max, mn, mx)
    assert (counts == C).all() and (lists[:, C - 1] == C - 1).all()


def test_flat_any_walk_near_the_list_limit_on_card(cuda):
    """K7 at C = 16381 (the list's power of two, 16384, is the most a
    block's shared memory holds; C not a multiple of 256): plate-64's
    clusters repeated 256 times. The mask equals the plain version's, the
    plain version's over the 64 clusters and K3's, bit for bit; C = 16385
    is refused."""
    fn, (sc, cam, _) = entry(cuda, scene="plate", n_clusters=64, width=32,
                             height=32)
    slabs, frame = sc["geom"]["packed9"], sc["frame"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    C = 16381
    big = slabs.repeat(256, 1, 1)[:C].contiguous()
    mn = frame["wc_aabb_min_w"].repeat(256, 1)[:C].contiguous()
    mx = frame["wc_aabb_max_w"].repeat(256, 1)[:C].contiguous()
    o, d, t_max = _mixed_rays(sc, 1031, 3, cuda)
    got = tf.trace_any_flat(big, mn, mx, o, d, 0.1, t_max)
    torch.cuda.synchronize()
    assert torch.equal(got, tf.trace_any_flat_plain(big, mn, mx, o, d, 0.1,
                                                    t_max))
    assert torch.equal(got, tf.trace_any_flat_plain(
        slabs, frame["wc_aabb_min_w"], frame["wc_aabb_max_w"], o, d, 0.1,
        t_max))
    assert torch.equal(got, tb.trace_any_bvh(slabs, *bvh, o, d, 0.1, t_max))
    assert got.any() and not got.all()
    over = torch.cat([big, slabs[:4]])
    with pytest.raises(ValueError, match="shared memory"):
        tf.trace_any_flat(over, torch.cat([mn, mn[:4]]),
                          torch.cat([mx, mx[:4]]), o, d, 0.1, t_max)


def _small_ibl(monkeypatch):
    """entry's build_ibl at test sizes (the full maps take about a minute
    on the CPU side)."""
    from prosper_tpu_torch import entry as entry_mod
    from prosper_tpu_torch.ops import ibl

    monkeypatch.setattr(entry_mod, "build_ibl", lambda env: {
        "brdf_lut": ibl.integrate_specular_brdf(32, 64, device=env.device),
        "irradiance": ibl.sample_irradiance(env, 8),
        "radiance_mips": ibl.prefilter_radiance(env, 16, n_samples=32)})


def _pt_dof_frame(dev, width, alpha_rounds=2):
    """A thin-lens PT sample of the blend/mask plate scene (aperture 0.1,
    focused at 18 units) -> (color (H, W, 3), ray count)."""
    static, frame, arena, cam_fn = make_plate_scene(
        64, 0, blend_every=8, mask_every=8)
    scene = from_numpy_scene(static, frame, arena, dev)
    cam = {**cam_fn(width, width), "aperture_diameter": np.float32(0.1),
           "focus_distance": np.float32(18.0)}
    c, n = pt.pt_render_sample(scene, cam, width, width, 1, 3, use_dof=True,
                               alpha_rounds=alpha_rounds, return_stats=True,
                               device=dev)
    return c.reshape(width, width, 3), n


@pytest.mark.parametrize("kind", ["alpha", "alpha_ibl", "alpha_no_bvh",
                                  "alpha_leafmajor", "dof"])
def test_pt_option_frames_on_card_match_cpu(cuda, kind, monkeypatch):
    """The path tracer's options on the card against the CPU, 64x64 on the
    blend/mask plate scene, alpha_rounds 2 (entry's default there): the
    retrace through K4 (K8 without BVH arrays; after the hybrid under
    leafmajor), the procedural sky as environment, and thin-lens DoF
    through K4. Equal ray counts, at most 1% of pixels off by more than
    1e-3."""
    if kind == "alpha_leafmajor":
        from prosper_tpu_torch import config

        monkeypatch.setattr(config.policy, "bounce_tracer", "leafmajor")
    out = []
    for dev in (cuda, "cpu"):
        if kind == "dof":
            img, n = _pt_dof_frame(dev, 64)
        else:
            fn, (sc, cam, _) = entry(
                dev, scene="plate", n_clusters=64, width=64, height=64,
                max_bounces=3, blend_every=8, mask_every=8,
                ibl=kind == "alpha_ibl", env_res=32,
                bvh=kind != "alpha_no_bvh")
            img, _, n = fn(sc, cam, 1)
        out.append((img.cpu(), int(n)))
    (img_g, n_g), (img_c, n_c) = out
    assert n_g == n_c
    assert bool(torch.isfinite(img_g).all())
    off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
    assert float(off) <= 0.01


@pytest.mark.parametrize("tech", ["multi_res", "fft"])
def test_post_chain_frames_on_card_match_cpu(cuda, tech, monkeypatch):
    """The culled deferred frame of the blend/mask plate scene with the
    CLI's full chain (IBL, TAA, bloom, DoF, particles), three frames with
    the state carried, on the card against the CPU: equal drawn meshlets,
    at most 1% of pixels off by more than 1e-3 in every frame."""
    _small_ibl(monkeypatch)
    kw = dict(scene="plate", n_clusters=64, width=64, height=64,
              mode="deferred", use_culling=True, scatter_lights=100,
              blend_every=8, mask_every=8, ibl=True, env_res=32,
              use_taa=True, use_bloom=True, bloom_technique=tech,
              use_dof=True, use_particles=True)
    runs = []
    for dev in (cuda, "cpu"):
        fn, (sc, cam, _) = entry(dev, **kw)
        state, frames = None, []
        for i in range(3):
            img, state, drawn = fn(sc, cam, i, state)
            frames.append((img.cpu(), int(drawn)))
        runs.append(frames)
    for (img_g, n_g), (img_c, n_c) in zip(*runs):
        assert n_g == n_c
        off = ((img_g - img_c).abs() > 1e-3).any(dim=-1).float().mean()
        assert float(off) <= 0.01


@pytest.mark.parametrize("mode", ["pt", "deferred", "forward", "restir"])
def test_cli_frames_on_card_match_cpu(cuda, mode, tmp_path):
    """The port's CLI at 64x64 on the card (--platform gpu, the kernels)
    against the same run with --platform cpu (the plain versions): at
    most 0.5% of the pixels off by more than 1e-3 + 1e-3 |want|."""
    from prosper_tpu_torch import testing
    from prosper_tpu_torch.app import cli

    path = testing.write_plate_gltf(tmp_path / "scene", 64, n_instanced=8,
                                    scatter_lights=100)
    frames = []
    for platform in ("gpu", "cpu"):
        dump = str(tmp_path / f"{platform}.png")
        assert cli.main(["render", path, "--platform", platform, "--mode",
                         mode, "--width", "64", "--height", "64",
                         "--frames", "3", "--out",
                         str(tmp_path / f"{platform}_out.png"),
                         "--dump-debug", dump]) == 0
        frames.append(np.load(dump + ".npy"))
    got, want = frames
    assert got.shape == want.shape == (64, 64, 3)
    off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
    assert off.mean() <= 0.005, off.mean()


def _spatial_call(device, monkeypatch, frame_index=3, **kw):
    """(args, kwargs) of the spatial_reuse call of one ReSTIR frame on
    device, and that frame's launches of the kernel."""
    from prosper_tpu_torch.render import restir

    calls = []
    real = restir.spatial_reuse

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    fn, (sc, cam, _) = entry(device, mode="restir", **kw)
    monkeypatch.setattr(restir, "spatial_reuse", rec)
    before = real.launches
    fn(sc, cam, frame_index)
    monkeypatch.setattr(restir, "spatial_reuse", real)
    assert len(calls) == 1
    return calls[0], real.launches - before


SPATIAL_FRAMES = {
    "plate64-64x64": dict(scene="plate", n_clusters=64, width=64, height=64,
                          scatter_lights=100),
    "plate64-64x64-nobvh": dict(scene="plate", n_clusters=64, width=64,
                                height=64, scatter_lights=100, bvh=False),
    "plate2048-1080p": dict(scene="plate", n_clusters=2048, width=1920,
                            height=1080, scatter_lights=1024),
}


def _assert_kernel_matches_plain(args, kwargs):
    """The kernel against its plain twin on one call's arguments: the
    light index equal on at least 99.99% of the pixels (both round every
    operation alike, so a pHat or a test an ulp apart is all that can
    flip one), the UCW within rtol 1e-5 where it agrees, NaN where the
    twin's is. -> (light index, UCW) of the kernel."""
    from prosper_tpu_torch.render import restir

    li, ucw = restir.spatial_reuse(*args, **kwargs)
    li_p, ucw_p = restir.spatial_reuse_plain(*args, **kwargs)
    assert li.dtype == li_p.dtype == torch.int64
    same = (li == li_p).cpu().numpy()
    assert same.mean() >= 0.9999, same.mean()
    assert bool((li >= 0).any())
    np.testing.assert_allclose(ucw.cpu().numpy()[same],
                               ucw_p.cpu().numpy()[same], rtol=1e-5,
                               atol=0.0, equal_nan=True)
    return li, ucw


@pytest.mark.parametrize("frame", sorted(SPATIAL_FRAMES))
def test_spatial_reuse_kernel_matches_plain_on_card(cuda, frame,
                                                    monkeypatch):
    """The spatial reuse kernel (csrc/restir_spatial.cu) against its plain
    twin on the card, on the inputs of one ReSTIR frame, with and
    without BVH arrays; each frame launches the kernel once."""
    (args, kwargs), launches = _spatial_call(cuda, monkeypatch,
                                             **SPATIAL_FRAMES[frame])
    assert launches == 1
    _assert_kernel_matches_plain(args, kwargs)


def test_spatial_reuse_kernel_spot_lights_match_plain_on_card(cuda,
                                                              monkeypatch):
    """The spot branch of the kernel's pHat (the angular falloff over the
    light row's direction, scale and offset) against the twin's: the
    64x64 frame's arguments with its odd point lights made spot lights
    aimed at surface points; some pixels must pick a lit spot light."""
    from prosper_tpu_torch.testing import as_spot_rows

    (args, kwargs), _ = _spatial_call(cuda, monkeypatch,
                                      **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights = args[:2]
    pos = surface["position_ws"][surface["valid"]]
    targets = pos[torch.randperm(pos.shape[0],
                                 generator=torch.Generator().manual_seed(2))
                  .to(pos.device)]
    n_points = int(lights["point_count"])
    rows = torch.from_numpy(as_spot_rows(
        lights["packed_rows"].cpu().numpy(), n_points,
        targets.cpu().numpy())).to(cuda)
    args = (surface, {**lights, "packed_rows": rows}, *args[2:])
    li, ucw = _assert_kernel_matches_plain(args, kwargs)
    spot = (li >= 0) & (rows[li.clamp_min(0), 0] == 2.0) & (ucw > 0)
    assert int(spot.sum()) > 0


def test_spatial_reuse_kernel_band_equals_full_frame_on_card(cuda,
                                                             monkeypatch):
    """The kernel on a band of rows over its rows and halo (neigh_y0,
    neigh_rows_h; zero rows past the frame's edges), as
    render/distributed.py calls it, equals the full frame's rows of the
    full-frame launch bit for bit."""
    from prosper_tpu_torch.render import distributed, restir

    (args, kwargs), _ = _spatial_call(cuda, monkeypatch,
                                      **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights, rows, px, py, width, height, frame = args
    full = restir.spatial_reuse(*args)
    up, dn = distributed.HALO_UP, distributed.HALO_DN
    padded = torch.cat([rows.new_zeros((up * width, 8)), rows,
                        rows.new_zeros((dn * width, 8))])
    for y0, band_h in ((40, 16), (0, 24), (48, 16)):
        sel = slice(y0 * width, (y0 + band_h) * width)
        band_s = {k: v[sel] if isinstance(v, torch.Tensor) and v.dim()
                  and v.shape[0] == width * height else v
                  for k, v in surface.items()}
        neigh = padded[y0 * width:(y0 + band_h + up + dn) * width]
        got = restir.spatial_reuse(
            band_s, lights, neigh, px[sel], py[sel], width, height, frame,
            neigh_y0=y0 - up, neigh_rows_h=band_h + up + dn)
        assert torch.equal(got[0], full[0][sel])
        assert torch.equal(got[1], full[1][sel])


def test_spatial_reuse_kernel_checks_inputs_on_card(cuda, monkeypatch):
    """The wrapper refuses what the kernel does not take: another dtype
    of px, a neighbour image of the wrong height, light rows off 16-byte
    alignment."""
    from prosper_tpu_torch.render import restir

    (args, kwargs), _ = _spatial_call(cuda, monkeypatch,
                                      **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights, rows, px, py, width, height, frame = args
    with pytest.raises(TypeError):
        restir.spatial_reuse(surface, lights, rows, px.int(), py, width,
                             height, frame)
    with pytest.raises(ValueError):
        restir.spatial_reuse(surface, lights, rows[:-width], px, py, width,
                             height, frame)
    packed = lights["packed_rows"]
    shifted = torch.empty(packed.numel() + 1, device=cuda)[1:].view_as(packed)
    shifted.copy_(packed)
    with pytest.raises(ValueError, match="aligned"):
        restir.spatial_reuse(surface, {**lights, "packed_rows": shifted},
                             rows, px, py, width, height, frame)


def _initial_call(device, monkeypatch, frame_index=3, **kw):
    """The arguments of the initial_neighbor_rows call of one ReSTIR
    frame on device, and that frame's launches of the kernel."""
    from prosper_tpu_torch.render import restir

    calls = []
    real = restir.initial_neighbor_rows

    def rec(*args):
        calls.append(args)
        return real(*args)

    fn, (sc, cam, _) = entry(device, mode="restir", **kw)
    monkeypatch.setattr(restir, "initial_neighbor_rows", rec)
    before = real.launches
    fn(sc, cam, frame_index)
    monkeypatch.setattr(restir, "initial_neighbor_rows", real)
    assert len(calls) == 1
    return calls[0], real.launches - before


def _assert_bits_equal(got, want):
    """Every element of two float32 tensors equal bit for bit (NaN where
    the other is NaN)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


# frame indices: one, and one past 2**32 (the RNG takes its low 32 bits)
INITIAL_FRAME_INDICES = (3, 2**32 + 17)


@pytest.mark.parametrize("frame_index", INITIAL_FRAME_INDICES)
@pytest.mark.parametrize("frame", ["plate64-64x64", "plate2048-1080p"])
def test_ris_initial_kernel_matches_plain_on_card(cuda, frame, frame_index,
                                                  monkeypatch):
    """The initial reservoirs kernel (csrc/restir_initial.cu) against its
    plain twin on the card, on the inputs of one ReSTIR frame: every
    column of every neighbour row equal bit for bit; the frame launches
    the kernel once."""
    from prosper_tpu_torch.render import restir

    args, launches = _initial_call(cuda, monkeypatch, frame_index,
                                   **SPATIAL_FRAMES[frame])
    assert launches == 1
    got = restir.initial_neighbor_rows(*args)
    want = restir.initial_neighbor_rows_plain(*args)
    _assert_bits_equal(got, want)
    assert bool((got[:, 4] >= 0).any())


def test_ris_initial_kernel_spot_lights_match_plain_on_card(cuda,
                                                            monkeypatch):
    """The spot branch of pHat and the light count read on the device:
    the 64x64 frame's arguments with its odd point lights made spot
    lights aimed at surface points, and 7 counted spot lights after the
    points (copies of the first spot rows), so every pick covers
    1 + P + 7 lights; rows bit for bit, some pixels keeping a lit spot
    light, some one of the 7."""
    from prosper_tpu_torch.render import restir
    from prosper_tpu_torch.testing import as_spot_rows

    args, _ = _initial_call(cuda, monkeypatch,
                            **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights = args[:2]
    pos = surface["position_ws"][surface["valid"]]
    targets = pos[torch.randperm(pos.shape[0],
                                 generator=torch.Generator().manual_seed(3))
                  .to(pos.device)]
    n_points = int(lights["point_count"])
    rows = torch.from_numpy(as_spot_rows(
        lights["packed_rows"].cpu().numpy(), n_points,
        targets.cpu().numpy())).to(cuda)
    rows[1 + n_points:8 + n_points] = rows[1:15:2]
    spots = {**lights, "packed_rows": rows,
             "spot_count": torch.tensor(7, dtype=torch.int32, device=cuda)}
    args = (surface, spots, *args[2:])
    got = restir.initial_neighbor_rows(*args)
    _assert_bits_equal(got, restir.initial_neighbor_rows_plain(*args))
    li = got[:, 4].long()
    kept = (li >= 0) & (got[:, 5] > 0)
    assert int((kept & (rows[li.clamp_min(0), 0] == 2.0)).sum()) > 0
    assert int((kept & (li > n_points)).sum()) > 0


def test_ris_initial_kernel_band_equals_full_frame_on_card(cuda,
                                                           monkeypatch):
    """The kernel on a band's pixels (their absolute px, py, as
    render/distributed.py passes them) equals the full frame's rows of
    the full-frame launch bit for bit."""
    from prosper_tpu_torch.render import restir

    args, _ = _initial_call(cuda, monkeypatch,
                            **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights, nm, valid, px, py, frame = args
    full = restir.initial_neighbor_rows(*args)
    R = px.shape[0]
    for r0, r1 in ((40 * 64, 56 * 64), (0, 24 * 64), (48 * 64, 64 * 64),
                   (17, 1000)):
        band_s = {k: v[r0:r1] if isinstance(v, torch.Tensor) and v.dim()
                  and v.shape[0] == R else v for k, v in surface.items()}
        got = restir.initial_neighbor_rows(
            band_s, lights, nm[r0:r1], valid[r0:r1], px[r0:r1], py[r0:r1],
            frame)
        _assert_bits_equal(got, full[r0:r1])


def test_ris_initial_kernel_checks_inputs_on_card(cuda, monkeypatch):
    """The wrapper refuses what the kernel does not take: another dtype
    of px or of the valid mask, normal_metallic of the wrong shape or
    off 16-byte alignment, light counts of another dtype, a light table
    shorter than light_uniforms lays out (the counts are read on the
    device), a frame index that is a tensor."""
    from prosper_tpu_torch.render import restir

    args, _ = _initial_call(cuda, monkeypatch,
                            **SPATIAL_FRAMES["plate64-64x64"])
    surface, lights, nm, valid, px, py, frame = args
    with pytest.raises(TypeError):
        restir.initial_neighbor_rows(surface, lights, nm, valid, px.int(),
                                     py, frame)
    with pytest.raises(TypeError):
        restir.initial_neighbor_rows(surface, lights, nm, valid.float(), px,
                                     py, frame)
    with pytest.raises(ValueError):
        restir.initial_neighbor_rows(surface, lights, nm[:, :3].contiguous(),
                                     valid, px, py, frame)
    shifted = torch.empty(nm.numel() + 1, device=cuda)[1:].view_as(nm)
    shifted.copy_(nm)
    with pytest.raises(ValueError, match="aligned"):
        restir.initial_neighbor_rows(surface, lights, shifted, valid, px, py,
                                     frame)
    with pytest.raises(TypeError):
        restir.initial_neighbor_rows(
            surface, {**lights, "point_count": lights["point_count"].long()},
            nm, valid, px, py, frame)
    with pytest.raises(ValueError, match="rows"):
        restir.initial_neighbor_rows(
            surface, {**lights, "packed_rows": lights["packed_rows"][:64]},
            nm, valid, px, py, frame)
    with pytest.raises(TypeError):
        restir.initial_neighbor_rows(surface, lights, nm, valid, px, py,
                                     torch.tensor(frame, device=cuda))
