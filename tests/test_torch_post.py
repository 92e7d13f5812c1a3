"""The deferred renderer's post chain in prosper_tpu_torch (ops/taa.py,
ops/bloom.py, ops/dof.py, ops/particles.py, render/readback.py and
render/deferred.py's pass order and state) against prosper_tpu on the
CPU.

Tolerances:
- integers, masks, slot allocation and particle masks exact; the
  particle pool after 130 steps rtol 1e-4 / atol 1e-5 (the same float32
  steps, but XLA's CPU backend fuses some a * b + c into one rounding,
  and an ulp a step accumulates);
- elementwise passes (TAA, the bloom taps and compose, DoF setup,
  flatten, dilate, median, combine) rtol 1e-5 / atol 1e-6;
- reordered sums (the streak convolution, the DoF gathers, the FFT
  kernel's supersampling mean) rtol 1e-4 / atol 1e-5; the FFT bloom
  within 1e-4 of the image's largest value (pocketfft on both sides
  here; cuFFT on the card rounds otherwise);
- frames over 3 frames with the state carried: at most 0.5% of the
  pixels off by more than 1e-3 + 1e-3 relative after the tone map
  (tests/test_torch_deferred.py's rule).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import bloom as jbloom
from prosper_tpu.ops import dof as jdof
from prosper_tpu.ops import particles as jpart
from prosper_tpu.ops import taa as jtaa
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render import readback as jread
from prosper_tpu.render.deferred import deferred_entry as j_deferred_entry
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import bloom as tbloom
from prosper_tpu_torch.ops import dof as tdof
from prosper_tpu_torch.ops import particles as tpart
from prosper_tpu_torch.ops import taa as ttaa
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import readback as tread
from prosper_tpu_torch.render.deferred import deferred_entry
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene

torch.set_num_threads(2)
W = H = 32
ELEMENTWISE = {"rtol": 1e-5, "atol": 1e-6}
REORDERED = {"rtol": 1e-4, "atol": 1e-5}
# a wide aperture focused inside the plate grid: DoF blurs both sides
DOF_CAM = {"aperture_diameter": np.float32(0.5),
           "focus_distance": np.float32(6.0)}


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _img(shape, seed, hi=2.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------- TAA


@pytest.mark.parametrize("h,w", [(20, 24), (9, 5)])
def test_taa_pieces_match_jax(h, w):
    illum, prev = _img((h, w, 3), 1), _img((h, w, 3), 2)
    vel = np.random.default_rng(3).normal(0, 0.1, (h, w, 2)).astype(
        np.float32)
    depth = np.random.default_rng(4).choice([0.0, 0.2, 0.5], (h, w)).astype(
        np.float32)  # ties: the first neighbour wins on both sides
    _close(ttaa.min_max_clip(_t(illum), _t(prev)),
           jtaa.min_max_clip(_j(illum), _j(prev)), ELEMENTWISE)
    _close(ttaa.variance_clip(_t(illum), _t(prev)),
           jtaa.variance_clip(_j(illum), _j(prev)), ELEMENTWISE)
    np.testing.assert_array_equal(
        ttaa.closest_velocity(_t(vel), _t(depth)).numpy(),
        np.asarray(jtaa.closest_velocity(_j(vel), _j(depth))))
    np.testing.assert_array_equal(
        ttaa.largest_velocity(_t(vel)).numpy(),
        np.asarray(jtaa.largest_velocity(_j(vel))))
    uv = np.random.default_rng(5).uniform(-0.2, 1.2, (h, w, 2)).astype(
        np.float32)
    _close(ttaa.bilinear_clamped(_t(prev), _t(uv)),
           jtaa._bilinear(_j(prev), _j(uv)), ELEMENTWISE)
    _close(ttaa.catmull_rom(_t(prev), _t(uv)),
           jtaa.catmull_rom(_j(prev), _j(uv)), REORDERED)


@pytest.mark.parametrize("opts", [
    {}, {"use_catmull_rom": False, "color_clipping": "minmax",
         "velocity_sampling": "largest", "luminance_weighting": False},
    {"color_clipping": "none", "velocity_sampling": "center"},
    {"ignore_history": True}])
def test_taa_resolve_matches_jax(opts):
    illum, prev = _img((16, 24, 3), 6), _img((16, 24, 3), 7)
    vel = np.random.default_rng(8).normal(0, 0.2, (16, 24, 2)).astype(
        np.float32)
    depth = _img((16, 24), 9, 1.0)
    got = ttaa.taa_resolve(_t(illum), _t(prev), _t(vel), _t(depth), **opts)
    want = jtaa.taa_resolve(_j(illum), _j(prev), _j(vel), _j(depth), **opts)
    _close(got, want, REORDERED)


# -------------------------------------------------------------- bloom


@pytest.mark.parametrize("quarter", [False, True])
def test_bloom_multi_res_matches_jax(quarter):
    illum = _img((36, 52, 3), 10, 4.0)
    _close(tbloom.separate(_t(illum), quarter=quarter),
           jbloom.separate(_j(illum), quarter=quarter), ELEMENTWISE)
    hl = tbloom.separate(_t(illum), quarter=quarter)
    for g, w in zip(tbloom.reduce_mips(hl), jbloom.reduce_mips(_j(hl))):
        _close(g, w, ELEMENTWISE)
    for vertical, streak in ((False, False), (True, False), (False, True)):
        _close(tbloom._blur_pass(hl, vertical, streak),
               jbloom._blur_pass(_j(hl), vertical, streak), REORDERED)
    got = tbloom.bloom_multi_res(_t(illum), quarter=quarter)
    want = jbloom.bloom_multi_res(_j(illum), quarter=quarter)
    _close(got, want, REORDERED)
    assert float((got - _t(illum)).abs().amax()) > 1e-2


def test_bloom_fft_matches_jax():
    k_t = tbloom.generate_kernel(32)
    k_j = jbloom.generate_kernel(32)
    _close(k_t, k_j, REORDERED)
    np.testing.assert_array_equal(
        tbloom.prepare_kernel(k_t, 16).numpy(),
        np.asarray(jbloom.prepare_kernel(_j(k_t), 16)))
    illum = _img((40, 56, 3), 11, 4.0)
    got = tbloom.bloom_fft(_t(illum))
    want = np.asarray(jbloom.bloom_fft(_j(illum)))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert float((got - _t(illum)).abs().amax()) > 1e-2
    cached = tbloom.bloom_fft(_t(illum), kernel_image=k_t)
    want = np.asarray(jbloom.bloom_fft(_j(illum), kernel_image=k_j))
    assert np.abs(cached.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------- DoF


def _dof_inputs(h=40, w=48):
    *_, cam_fn = ttesting.make_plate_scene(27, 1)
    # a wider aperture still: background CoCs over a pixel
    cam = {**cam_fn(w, h), **DOF_CAM, "aperture_diameter": np.float32(1.5)}
    rng = np.random.default_rng(12)
    illum = _img((h, w, 3), 13, 3.0)
    depth = np.where(rng.uniform(size=(h, w)) < 0.5, 2.0, 14.0)
    depth = (depth + rng.uniform(0, 1, (h, w))).astype(np.float32)
    return illum, depth, cam


def test_dof_pieces_match_jax():
    illum, depth, cam = _dof_inputs()
    tcam, jcam = camera_tensors(cam, "cpu"), _jdev(cam)
    hi_t, hc_t = tdof.setup(_t(illum), _t(depth), tcam)
    hi_j, hc_j = jdof.setup(_j(illum), _j(depth), jcam)
    _close(hi_t, hi_j, ELEMENTWISE)
    _close(hc_t, hc_j, ELEMENTWISE)
    assert float(hc_t.amin()) < -0.5 and float(hc_t.amax()) > 1.0
    tmin, tmax = tdof.flatten(hc_t)
    for g, w in zip((tmin, tmax), jdof.flatten(_j(hc_t))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dmin, dmax = tdof.dilate(tmin, tmax, 4)
    for g, w in zip((dmin, dmax), jdof.dilate(_j(tmin), _j(tmax), 4)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    args_t = (hi_t, hc_t, dmin, dmax)
    args_j = tuple(_j(a) for a in args_t)
    bg = tdof.gather_background(*args_t)
    _close(bg, jdof.gather_background(*args_j), REORDERED)
    fg = tdof.gather_foreground(*args_t)
    _close(fg, jdof.gather_foreground(*args_j), REORDERED)
    bg4 = torch.cat([bg, torch.zeros_like(bg[..., :1])], -1)
    np.testing.assert_array_equal(tdof.median3x3(fg).numpy(),
                                  np.asarray(jdof.median3x3(_j(fg))))
    _close(tdof.combine(_t(illum), fg, bg4, hc_t),
           jdof.combine(_j(illum), _j(fg), _j(bg4), _j(hc_t)), ELEMENTWISE)


def test_dof_trilinear_taps_match_jax():
    """The port taps two levels of the half-resolution chain per sample;
    the JAX package taps all four and selects: equal to a four-level loop
    bit for bit, and to JAX's within the elementwise tolerance, also at
    levels past the chain and off the image."""
    img = _img((37, 53, 4), 19)
    rng = np.random.default_rng(20)
    uv = (rng.uniform(-0.2, 1.2, (5, 200, 2))).astype(np.float32)
    mip = rng.uniform(-1, 5, (5, 200)).astype(np.float32)
    mip[0, :8] = [0, 1, 2, 3, 4, 2.5, 3.0, -0.0]
    mips = tdof._mip_chain(_t(img))
    got = tdof._sample_trilinear(tdof._pyramid(mips), _t(uv), _t(mip))
    m = torch.clamp(_t(mip), 0.0, 3.0)
    m0 = torch.floor(m)
    f = (m - m0)[..., None]
    loop = torch.zeros(got.shape)
    for lvl, level in enumerate(mips):
        s = ttaa.bilinear_clamped(level, _t(uv))
        loop = (loop + torch.where((m0 == lvl)[..., None], s * (1 - f), 0.0)
                + torch.where((m0 == lvl - 1)[..., None], s * f, 0.0))
    assert torch.equal(got, loop)
    want = jdof._sample_trilinear(jdof._mip_chain(_j(img)), _j(uv), _j(mip))
    _close(got, want, ELEMENTWISE)


def test_depth_of_field_matches_jax():
    illum, depth, cam = _dof_inputs()
    got = tdof.depth_of_field(_t(illum), _t(depth), camera_tensors(cam,
                                                                   "cpu"))
    want = jdof.depth_of_field(_j(illum), _j(depth), _jdev(cam))
    _close(got, want, REORDERED)
    assert float((got - _t(illum)).abs().mean()) > 1e-2


# ---------------------------------------------------------- particles


def _pool_equal(got, want):
    for k in ("position_lifetime", "normal_spawnrate",
              "velocity_spawntimer"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **REORDERED)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]).astype(np.int32))


def test_allocate_matches_jax():
    rng = np.random.default_rng(14)
    for n_dead in (0, 5, 40):
        dead = np.zeros(64, bool)
        dead[rng.choice(64, n_dead, replace=False)] = True
        want = rng.uniform(size=30) < 0.5
        s_t, g_t = tpart._allocate(_t(dead), _t(want))
        s_j, g_j = jpart._allocate(_j(dead), _j(want))
        g = np.asarray(g_j)
        np.testing.assert_array_equal(g_t.numpy(), g)
        np.testing.assert_array_equal(s_t.numpy()[g], np.asarray(s_j)[g])


def test_particles_match_jax():
    """Emitters at 40 points in a pool of 256 (so the children run out of
    slots), 130 steps of 1/60 s with the frame index advancing, then the
    splats over a depth-tested frame."""
    rng = np.random.default_rng(15)
    pos = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (40, 1))
    st_t = tpart.spawn_emitters(tpart.init_state(256), _t(pos), _t(nrm))
    st_j = jpart.spawn_emitters(jpart.init_state(256), _j(pos), _j(nrm))
    _pool_equal(st_t, st_j)
    for i in range(130):
        st_t = tpart.simulate(st_t, 1.0 / 60.0, i)
        st_j = jpart.simulate(st_j, 1.0 / 60.0, i)
    _pool_equal(st_t, st_j)
    alive = st_t["position_lifetime"][:, 3] >= 0
    assert int(alive.sum()) == 256  # the pool filled
    *_, cam_fn = ttesting.make_plate_scene(27, 1)
    cam = cam_fn(64, 48)
    cam["world_to_clip"] = cam["world_to_clip"].astype(np.float32)
    hdr = _img((48, 64, 3), 16, 0.5)
    depth = _img((48, 64), 17, 0.02)
    got = tpart.render_particles(st_t, _t(hdr), _t(depth),
                                 camera_tensors(cam, "cpu"))
    want = jpart.render_particles(st_j, _j(hdr), _j(depth), _jdev(cam))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got != _t(hdr)).any(-1).sum()) > 0


# ----------------------------------------------------------- readback


def test_readback_matches_jax():
    depth = _img((30, 40), 18, 0.05)
    *_, cam_fn = ttesting.make_plate_scene(27, 1)
    cam = cam_fn(40, 30)
    rb_t, rb_j = tread.TextureReadback(), jread.TextureReadback()
    assert rb_t.poll() is None
    for uv in ((0.5, 0.5), (0.0, 0.999), (1.0, 1.0)):
        rb_t.queue(_t(depth), uv)
        rb_j.queue(_j(depth), uv)
        got, want = rb_t.poll(), rb_j.poll()
        assert float(got) == float(want)
        assert rb_t.poll() is None
        assert tread.focus_from_depth(float(got), cam) == \
            jread.focus_from_depth(float(want), cam)
        assert tread.pick_focus_distance(_t(depth), cam, uv) == \
            jread.pick_focus_distance(_j(depth), cam, uv)
    stats = tread.DrawStats()
    assert stats.poll() is None
    stats.record({"drawn_meshlets": torch.tensor(7)})
    assert stats.poll() == {"drawn_meshlets": 7} and stats.poll() is None


# ------------------------------------------------------------- frames


@pytest.fixture(scope="module")
def plate():
    static, frame, arena, cam_fn = ttesting.make_plate_scene(
        27, 1, scatter_lights=64)
    cam = {**cam_fn(W, H), **DOF_CAM}
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    return ((js, jf, ja, _jdev(cam)),
            (from_numpy_scene(static, frame, arena, "cpu"),
             camera_tensors(cam, "cpu")))


FLAGS = {
    "taa": {"use_taa": True},
    "bloom": {"use_bloom": True},
    "bloom_fft": {"use_bloom": True, "bloom_technique": "fft"},
    "dof": {"use_dof": True},
    "particles": {"use_particles": True},
    "all": {"use_taa": True, "use_bloom": True, "use_dof": True,
            "use_particles": True, "use_culling": True},
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_deferred_frames_with_post_match_jax(plate, name):
    """Three deferred frames with the state carried (TAA history,
    particles, FFT kernel, HiZ) against the JAX package's deferred_entry;
    each flag changes the frame."""
    (js, jf, ja, jcam), (scene, tcam) = plate
    flags = FLAGS[name]
    lut = pack_lut_quads(synthetic_lut())
    run_j = partial(j_deferred_entry, static=js, frame=jf, arena=ja, cam=jcam,
                    lut=jnp.asarray(lut), width=W, height=H, **flags)
    run_t = partial(deferred_entry, scene=scene, cam=tcam, lut=lut, width=W,
                    height=H, device="cpu", **flags)
    st_j = st_t = None
    for i in range(3):
        want, st_j = run_j(state=st_j, frame_index=i)
        got, st_t = run_t(state=st_t, frame_index=i)
        want = np.asarray(want)
        off = (np.abs(got.numpy() - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
        assert off.mean() <= 5e-3, (i, off.sum())
    assert (st_t["taa_history"] is not None) == bool(flags.get("use_taa"))
    assert (st_t["particles"] is not None) == bool(flags.get("use_particles"))
    assert (st_t["bloom_kernel"] is not None) == (
        flags.get("bloom_technique") == "fft")
    plain, _ = deferred_entry(scene=scene, cam=tcam, lut=lut, width=W,
                              height=H, device="cpu", frame_index=2)
    if name != "taa":  # a still camera: the history equals the frame
        assert float((got - plain).abs().amax()) > 1e-3
