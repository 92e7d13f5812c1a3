"""The path tracer's options in prosper_tpu_torch (thin-lens DoF,
environment lighting, stochastic alpha) against prosper_tpu on the CPU.

The JAX package runs the alpha retrace only on its kernel path
(render/pt.py:301, `use_full_kernel`), so every frame here is held
against that path: jax.default_backend patched, the Pallas kernels in
interpret mode (tests/test_torch_pt.py's harness). Those kernels fix
t_min at 1e-4 in the kernel, so the port passes 1e-4 for its primary,
bounce and retrace traces here (pt.BOUNCE_T_MIN, pt.ALPHA_T_MIN).

Frames of the blend/mask plate scene, 32x32, 2 bounces, alpha_rounds 2:
ray counts equal, colors within rtol 1e-4 / atol 1e-5 (the same kernel
path, float32 rounding of the ray setup). The JAX package's kernel path
without BVH arrays passes perm= and packed= to the flat kernels, which
take neither (pt.py:296, :449); the harness applies the permutation
around them (`_flat_adapters`), which leaves every ray's result alone.

Helpers: integers exact (rnd3d01, hammersley's radical inverse);
elementwise functions rtol 1e-5 / atol 1e-6.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu import config as jconfig
from prosper_tpu.mathx import rng as jrng
from prosper_tpu.ops import brdf as jbrdf
from prosper_tpu.ops import trace as jtrace
from prosper_tpu.ops import trace_pallas_full as jfull
from prosper_tpu.ops.ibl import procedural_sky as j_sky
from prosper_tpu.ops.rays import thin_lens_rays as j_thin_lens
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.ops.trace_bvh import pack_hit16 as j_pack_hit16
from prosper_tpu.render import pt as jpt
from prosper_tpu_torch import config, testing
from prosper_tpu_torch.mathx import rng as trng
from prosper_tpu_torch.ops import brdf as tbrdf
from prosper_tpu_torch.ops.ibl import procedural_sky
from prosper_tpu_torch.ops.rays import thin_lens_rays
from prosper_tpu_torch.render import pt
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene
from tests.test_trace_leafmajor import interpret_mode

torch.set_num_threads(2)
W = H = 32
BOUNCES = 2
ELEMENTWISE = {"rtol": 1e-5, "atol": 1e-6}
# a large aperture: the thin lens blurs the plates by several pixels
DOF_CAM = {"aperture_diameter": np.float32(0.5),
           "focus_distance": np.float32(6.0)}


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def test_rnd3d01_and_hammersley_equal_jax():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (4000, 3), dtype=np.uint64)
    st_t, u_t = trng.rnd3d01(torch.as_tensor(words.astype(np.int64)))
    st_j, u_j = jrng.rnd3d01(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j).astype(
        np.int64))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    i = np.concatenate([np.arange(300), rng.integers(0, 2**32, 300,
                                                     dtype=np.uint64)])
    got = trng.hammersley(torch.as_tensor(i.astype(np.int64)), 1024)
    want = jrng.hammersley(jnp.asarray(i.astype(np.uint32)), 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ibl_brdf_helpers_match_jax():
    rng = np.random.default_rng(1)
    f = np.float32
    voh, rough = rng.uniform(0, 1, 500).astype(f), rng.uniform(0, 1, 500)
    f0 = rng.uniform(0, 1, (500, 3)).astype(f)
    np.testing.assert_allclose(
        tbrdf.schlick_fresnel_with_roughness(
            torch.as_tensor(voh), torch.as_tensor(f0),
            torch.as_tensor(rough.astype(f))).numpy(),
        np.asarray(jbrdf.schlick_fresnel_with_roughness(
            jnp.asarray(voh), jnp.asarray(f0), jnp.asarray(rough.astype(f)))),
        **ELEMENTWISE)
    xi = rng.uniform(0, 1, (500, 2)).astype(f)
    n = rng.normal(size=(500, 3)).astype(f)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[0, 0, 1], [0, 0, -1], [0, 0.0005, 0.9999999]]
    alpha = rng.uniform(0, 1, 500).astype(f)
    np.testing.assert_allclose(
        tbrdf.importance_sample_ibl_trowbridge_reitz(
            torch.as_tensor(xi), torch.as_tensor(alpha),
            torch.as_tensor(n)).numpy(),
        np.asarray(jbrdf.importance_sample_ibl_trowbridge_reitz(
            jnp.asarray(xi), jnp.asarray(alpha), jnp.asarray(n))),
        rtol=1e-5, atol=2e-6)


def test_thin_lens_rays_match_jax():
    *_, cam_fn = testing.make_plate_scene(27, 1)
    cam = {**cam_fn(W, H), **DOF_CAM}
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 1, (2000, 2)).astype(np.float32)
    lens = rng.uniform(0, 1, (2000, 2)).astype(np.float32)
    o, d = thin_lens_rays(camera_tensors(cam, "cpu"), torch.as_tensor(uv),
                          torch.as_tensor(lens))
    jo, jd = j_thin_lens(_jdev(cam), jnp.asarray(uv), jnp.asarray(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **ELEMENTWISE)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **ELEMENTWISE)
    # the lens spreads the origins over the aperture
    assert float(o.std(dim=0).amax()) > 0.01


def _perm_adapter(fn, pack=False):
    def run(*args, perm=None, packed=False, tile=None, **kw):
        *head, o, d, t_min, t_max = args
        if perm is not None:
            o, d = o[perm], d[perm]
            t_max = t_max[perm] if jnp.ndim(t_max) else t_max
        out = fn(*head, o, d, t_min, t_max, **kw)
        return j_pack_hit16(out) if (pack and packed) else out
    return run


@contextlib.contextmanager
def _flat_adapters():
    """The JAX package's flat kernels behind the perm=/packed= calls its
    kernel path makes without BVH arrays."""
    real_tracer = jtrace.make_tracer

    def make_tracer(*a, **k):
        closest, any_fn = real_tracer(*a, **k)
        return _perm_adapter(closest), _perm_adapter(any_fn)

    with mock.patch.object(jtrace, "make_tracer", make_tracer), \
            mock.patch.object(jfull, "trace_closest_full", _perm_adapter(
                jfull.trace_closest_full, pack=True)):
        yield


def _frames(bvh=True, leafmajor=False, env=False, clamp_indirect=False,
            use_dof=False, frame_index=1, monkeypatch=None):
    """(jax color, jax rays, port color, port rays) of one frame of the
    blend/mask plate scene on the JAX kernel path (interpret mode)."""
    static, frame, arena, cam_fn = testing.make_plate_scene(
        27, 1, blend_every=4, mask_every=4)
    if not bvh:
        frame = {k: v for k, v in frame.items()
                 if k not in ("bvh_bounds", "bvh_meta", "bvh_nodes8")}
    cam = cam_fn(W, H)
    if use_dof:
        cam = {**cam, **DOF_CAM}
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    opts = {"max_bounces": BOUNCES, "alpha_rounds": 2, "use_dof": use_dof,
            "clamp_indirect": clamp_indirect}
    jax.clear_caches()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(interpret_mode())
            stack.enter_context(mock.patch.object(
                jax, "default_backend", lambda: "tpu"))
            stack.enter_context(mock.patch.object(
                jconfig.policy, "bounce_tracer",
                "leafmajor" if leafmajor else "packet"))
            if not bvh:
                stack.enter_context(_flat_adapters())
            jc, jn = jpt.pt_render_sample(
                js, jf, ja, _jdev(cam), W, H, frame_index, return_stats=True,
                env=j_sky(8) if env else None, **opts)
            jc, jn = np.asarray(jc), int(jn)
    finally:
        jax.clear_caches()
    monkeypatch.setattr(config.policy, "bounce_tracer",
                        "leafmajor" if leafmajor else "packet")
    monkeypatch.setattr(pt, "BOUNCE_T_MIN", 1e-4)
    monkeypatch.setattr(pt, "ALPHA_T_MIN", 1e-4)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    tc, tn = pt.pt_render_sample(
        scene, cam, W, H, frame_index, return_stats=True, device="cpu",
        env=procedural_sky(8) if env else None, **opts)
    return jc, jn, tc.numpy(), int(tn)


@pytest.mark.parametrize("kind", ["bvh", "no_bvh", "leafmajor"])
def test_alpha_frames_match_jax_kernel_path(kind, monkeypatch):
    """alpha_rounds 2 on BVH frames (K1, K2 + attributes, K4 retraces),
    without BVH arrays (K8 primary, bounce and retraces) and under
    bounce_tracer = "leafmajor" (the hybrid's closest_full, then K4)."""
    jc, jn, tc, tn = _frames(bvh=kind != "no_bvh",
                             leafmajor=kind == "leafmajor",
                             monkeypatch=monkeypatch)
    assert tn == jn
    assert (jc.sum(-1) > 0).mean() > 0.05
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-5)
    # the retrace changes the frame: blend and mask plates are seen through
    monkeypatch.setattr(pt, "BOUNCE_T_MIN", 1e-4)
    static, frame, arena, cam_fn = testing.make_plate_scene(
        27, 1, blend_every=4, mask_every=4)
    if kind == "no_bvh":
        frame = {k: v for k, v in frame.items()
                 if k not in ("bvh_bounds", "bvh_meta", "bvh_nodes8")}
    opaque = pt.pt_render_sample(
        from_numpy_scene(static, frame, arena, "cpu"), cam_fn(W, H), W, H,
        1, BOUNCES, device="cpu").numpy()
    assert (np.abs(opaque - tc) > 1e-3).any(-1).mean() > 0.01


@pytest.mark.parametrize("clamp", [False, True])
def test_env_frames_match_jax_kernel_path(clamp, monkeypatch):
    """The procedural sky lighting primary and bounce misses, with and
    without the indirect clamp."""
    jc, jn, tc, tn = _frames(env=True, clamp_indirect=clamp,
                             monkeypatch=monkeypatch)
    assert tn == jn
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-5)
    assert (tc.sum(-1) > 0).mean() > 0.9  # the sky fills the background


def test_dof_frame_matches_jax_kernel_path(monkeypatch):
    """Thin-lens primary rays (the lens draw after the jitter), traced by
    K4 at t_min 0 instead of K1's raygen."""
    jc, jn, tc, tn = _frames(use_dof=True, monkeypatch=monkeypatch)
    assert tn == jn
    assert (jc.sum(-1) > 0).mean() > 0.05
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-5)
