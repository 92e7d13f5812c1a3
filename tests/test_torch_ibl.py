"""Image-based lighting of prosper_tpu_torch (ops/ibl.py, the IBL term of
the deferred frame and of the transparent pass, the skybox) against
prosper_tpu on the CPU.

Tolerances:
- face directions and the packed rows exact (the same numpy, the same
  copies);
- elementwise functions (cubemap taps, the sky, prefiltered taps,
  eval_ibl) rtol 1e-5 / atol 1e-6;
- the quadratures (split-sum LUT, irradiance, prefiltered mips) rtol
  1e-4 / atol 1e-5: the JAX package adds one sample at a time, the port
  a chunk of samples at a time (another summation order);
- frames: at most 0.5% of the pixels off by more than 1e-3 + 1e-3
  relative after the tone map (tests/test_torch_deferred.py's rule).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import ibl as J
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render.deferred import render_deferred as j_render_deferred
from prosper_tpu.render.transparent import transparent_pass as j_transparent
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import ibl as T
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render.deferred import deferred_entry
from prosper_tpu_torch.render.transparent import (
    blend_cluster_mask,
    transparent_pass,
)
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene

torch.set_num_threads(2)
W = H = 32
ELEMENTWISE = {"rtol": 1e-5, "atol": 1e-6}
QUADRATURE = {"rtol": 1e-4, "atol": 1e-5}


def _j(t):
    return jnp.asarray(np.asarray(t))


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _dirs(n, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]] * np.array(
        [1, 1, 1, -1, -1, -1], np.float32)[:, None]  # the face centers
    return d


def small_ibl(env: torch.Tensor) -> dict:
    """build_ibl's maps at test sizes (the full ones take about a minute
    on the CPU), with the environment."""
    return {"brdf_lut": T.integrate_specular_brdf(16, 64, device=env.device),
            "irradiance": T.sample_irradiance(env, 4),
            "radiance_mips": T.prefilter_radiance(env, 8, n_samples=32),
            "env": env}


def _ibl_pair(env_res=8):
    """(port IBL data, the same numbers for the JAX package)."""
    t = small_ibl(T.procedural_sky(env_res))
    j = {"brdf_lut": _j(t["brdf_lut"]), "irradiance": _j(t["irradiance"]),
         "radiance_mips": [_j(m) for m in t["radiance_mips"]],
         "env": _j(t["env"])}
    return t, j


@pytest.mark.parametrize("res", [1, 4, 7])
def test_face_directions_and_packed_rows_equal_jax(res):
    got = T.face_directions(res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        J.face_directions(res)))
    cube = np.random.default_rng(res).uniform(0, 2, (6, res, res, 3))
    cube = cube.astype(np.float32)
    np.testing.assert_array_equal(
        T.pack_cubemap_rows(torch.as_tensor(cube)).numpy(),
        np.asarray(J.pack_cubemap_rows(jnp.asarray(cube))))


@pytest.mark.parametrize("res", [2, 5, 16])
def test_sample_cubemap_and_sky_match_jax(res):
    sky = T.procedural_sky(res)
    np.testing.assert_allclose(sky.numpy(), np.asarray(J.procedural_sky(res)),
                               **ELEMENTWISE)
    d = _dirs(3000, res)
    want = np.asarray(J.sample_cubemap(_j(sky), jnp.asarray(d)))
    got = T.sample_cubemap(sky, torch.as_tensor(d))
    np.testing.assert_allclose(got.numpy(), want, **ELEMENTWISE)
    packed = T.pack_cubemap_rows(sky)
    assert torch.equal(T.sample_cubemap(packed, torch.as_tensor(d)), got)
    with pytest.raises(ValueError, match="packed"):
        T.sample_cubemap(packed[:-1], torch.as_tensor(d))


def test_quadratures_match_jax():
    lut = T.integrate_specular_brdf(16, 96)
    np.testing.assert_allclose(
        lut.numpy(), np.asarray(J.integrate_specular_brdf(res=16,
                                                          n_samples=96)),
        **QUADRATURE)
    env = T.procedural_sky(8)
    np.testing.assert_allclose(
        T.sample_irradiance(env, 4).numpy(),
        np.asarray(J.sample_irradiance(_j(env), out_res=4)), **QUADRATURE)
    got = T.prefilter_radiance(env, res=8, n_mips=3, n_samples=40)
    want = J.prefilter_radiance(_j(env), res=8, n_mips=3, n_samples=40)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **QUADRATURE)
    n = T.face_directions(4)
    np.testing.assert_allclose(
        T._prefilter_mip(T.pack_cubemap_rows(env), n, 0.3, 24).numpy(),
        np.asarray(J._prefilter_mip(_j(env), _j(n), 0.3, 24)), **QUADRATURE)


def _surface(n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    nrm = _dirs(n, seed + 1)
    view = _dirs(n, seed + 2)
    return {
        "normal_ws": nrm, "inv_view_ray": view,
        "albedo": rng.uniform(0, 1, (n, 3)).astype(f),
        "roughness": rng.uniform(0, 1, n).astype(f),
        "metallic": rng.choice([0.0, 0.3, 1.0], n).astype(f),
        "NoV": np.clip((nrm * view).sum(-1), 0, 1).astype(f),
    }


def test_sample_prefiltered_and_eval_ibl_match_jax():
    t, j = _ibl_pair()
    s = _surface(2000, 3)
    lod = np.random.default_rng(5).uniform(-1, 4, 2000).astype(np.float32)
    np.testing.assert_allclose(
        T.sample_prefiltered(t["radiance_mips"], torch.as_tensor(
            s["normal_ws"]), torch.as_tensor(lod)).numpy(),
        np.asarray(J.sample_prefiltered(j["radiance_mips"], jnp.asarray(
            s["normal_ws"]), jnp.asarray(lod))), **ELEMENTWISE)
    got = T.eval_ibl({k: torch.as_tensor(v) for k, v in s.items()}, t)
    want = J.eval_ibl({k: jnp.asarray(v) for k, v in s.items()}, j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEMENTWISE)
    assert float(got.abs().mean()) > 0.01


def test_build_ibl_composes_the_maps_at_the_jax_sizes(monkeypatch):
    """build_ibl's three maps at the JAX package's sizes: each quadrature
    is recorded (they take about a minute together on the CPU) and the
    composition checked."""
    calls = []

    def rec(name):
        def fn(*args, **kw):
            calls.append((name, args, kw))
            return name
        return fn

    for name in ("integrate_specular_brdf", "sample_irradiance",
                 "prefilter_radiance"):
        monkeypatch.setattr(T, name, rec(name))
    env = T.procedural_sky(4)
    got = T.build_ibl(env)
    assert got == {"brdf_lut": "integrate_specular_brdf",
                   "irradiance": "sample_irradiance",
                   "radiance_mips": "prefilter_radiance"}
    assert calls[0] == ("integrate_specular_brdf", (), {"device": env.device})
    assert [c[1][0] is env for c in calls[1:]] == [True, True]
    assert all(len(c[1]) == 1 and not c[2] for c in calls[1:])
    monkeypatch.undo()
    # the defaults are the JAX package's
    for name, params in (("integrate_specular_brdf", (512, 1024)),
                         ("sample_irradiance", (64,)),
                         ("prefilter_radiance", (128, 8, 256))):
        d = getattr(T, name).__defaults__
        assert d[:len(params)] == params, name


@pytest.fixture(scope="module")
def plate():
    static, frame, arena, cam_fn = ttesting.make_plate_scene(
        27, 1, scatter_lights=64, blend_every=4, mask_every=4)
    cam = cam_fn(W, H)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    flat = {k: v for k, v in frame.items()
            if k not in ("bvh_bounds", "bvh_meta", "bvh_nodes8")}
    port = {"bvh": from_numpy_scene(static, frame, arena, "cpu"),
            "flat": from_numpy_scene(static, flat, arena, "cpu")}
    return (js, jf, ja, _jdev(cam)), port, camera_tensors(cam, "cpu")


def _frames_close(got, want, share=5e-3):
    off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
    assert off.mean() <= share, off.sum()


@pytest.mark.parametrize("use_culling", [False, True])
def test_deferred_frame_with_ibl_and_skybox_matches_jax(plate, use_culling):
    """The deferred frame with the IBL term and the skybox against
    render_deferred, the same IBL maps; the sky fills the background."""
    (js, jf, ja, jcam), port, tcam = plate
    t_ibl, j_ibl = _ibl_pair()
    lut = pack_lut_quads(synthetic_lut())
    want, _ = j_render_deferred(js, jf, ja, jcam, jnp.asarray(lut), W, H,
                                ibl_data=j_ibl, use_culling=use_culling,
                                use_transparent=True, alpha_rounds=2)
    run = partial(deferred_entry, scene=port["bvh"], cam=tcam, lut=lut,
                  width=W, height=H, device="cpu", use_culling=use_culling,
                  use_transparent=True, alpha_rounds=2)
    got, state = run(ibl_data=t_ibl)
    _frames_close(got.numpy(), np.asarray(want))
    plain, _ = run()
    background = state["depth"].numpy() == 0
    assert 0.05 < background.mean() < 0.95
    sky_moved = (got - plain).abs().amax(-1).numpy() > 1e-3
    assert sky_moved[background].all()
    assert sky_moved[~background].mean() > 0.5  # the IBL term lights


@pytest.mark.parametrize("branch", ["bvh", "flat"])
def test_transparent_pass_with_ibl_matches_jax(plate, branch):
    """Both branches of the transparent pass (K4 with the blend mask, K8
    over masked AABBs) with the IBL term against the JAX package's."""
    (js, jf, ja, jcam), port, tcam = plate
    t_ibl, j_ibl = _ibl_pair()
    scene = port[branch]
    hdr = torch.as_tensor(np.random.default_rng(4).uniform(
        0, 1, (H, W, 3)).astype(np.float32))
    z = torch.full((W * H,), float("-inf"))
    got = transparent_pass(scene, tcam, hdr, z, W, H, t_ibl)
    want = j_transparent(js, jf, ja, jcam, _j(hdr), _j(z), W, H, j_ibl)
    _frames_close(got.numpy(), np.asarray(want))
    plain = transparent_pass(scene, tcam, hdr, z, W, H)
    blend = blend_cluster_mask(scene)
    assert bool(blend.any())
    assert float((got - plain).abs().amax()) > 1e-3
    assert bool(torch.isfinite(got).all())
