"""ReSTIR DI of prosper_tpu_torch (render/restir.py) against
prosper_tpu.render.restir on the CPU: each pass on the same numpy
inputs, then whole frames through restir_entry.

Scenes: the test scene (four boxes, the sun and one point light) and
plate-64 with 16 scattered point lights, at 32x32 and 64x64. The passes'
inputs are the JAX CPU G-buffer of the scene (made from the scene's
seed), handed to both packages as numpy arrays. The port's frames run
with BVH arrays under both any-hit policies (config.policy.any_tracer
"stack": K3, "dense": K10) and without BVH arrays (K8 G-buffer, K7
shadows), all as plain versions on the CPU; the JAX CPU frame traces
with its XLA tracer, whose contract the kernels share.

Tolerances:
- reservoir light indices equal on at least 99.9% of the pixels: the two
  packages evaluate pHat with the same float32 operations in another
  fusion, so a pHat a rounding apart can flip one accept test;
- UCW within rtol 1e-4 where the indices agree;
- neighbour rows exact (a concatenation);
- shading: colour within rtol 1e-4 / atol 1e-6 on all but 0.1% of the
  pixels (the same occlusion; rounding of the BRDF terms);
- frames (tone-mapped, frames 0 and 1 accumulated): at most 0.5% of the
  pixels off by more than 1e-3 + 1e-3 relative, the rule of
  test_torch_deferred.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import trace as jtrace
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render import restir as jrestir
from prosper_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from prosper_tpu_torch import config
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import restir
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene

torch.set_num_threads(2)

SCENES = {
    "boxes": lambda: ttesting.make_test_scene(4),
    "plate": lambda: ttesting.make_plate_scene(64, 0, scatter_lights=16),
}
# label -> (BVH arrays in the frame, config.policy.any_tracer)
TRACERS = {"bvh_stack": (True, "stack"), "bvh_dense": (True, "dense"),
           "no_bvh": (False, "stack")}
SURFACE_KEYS = ("position_ws", "normal_ws", "inv_view_ray", "albedo",
                "roughness", "metallic", "alpha", "valid", "linear_depth")

_j_gbuffer = jax.jit(j_render_gbuffer, static_argnames=("width", "height"))


def _jdev(tree):
    return {
        k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
        for k, v in tree.items()
    }


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.as_tensor(np.array(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module",
                params=[(s, n) for s in sorted(SCENES) for n in (32, 64)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """The scene in both packages, the JAX G-buffer's shading inputs as
    numpy, and the JAX CPU frames 0 and 1 of restir_entry."""
    name, n = request.param
    static, frame, arena, cam_fn = SCENES[name]()
    cam = cam_fn(n, n)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    jcam = _jdev(cam)
    gbuf = _j_gbuffer(js, jf, ja, jcam, width=n, height=n)
    c2c = jcam["camera_to_clip"]
    surface = dict(gbuf["surface"])
    surface["linear_depth"] = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
    surface = {k: np.asarray(surface[k]) for k in SURFACE_KEYS}
    lut = pack_lut_quads(synthetic_lut())
    jframes, state = [], None
    for f in (0, 1):
        img, state = jrestir.restir_entry(
            static=js, frame=jf, arena=ja, cam=jcam, lut=jnp.asarray(lut),
            width=n, height=n, frame_index=f, state=state)
        jframes.append(np.asarray(img))
    return {
        "n": n, "numpy": (static, frame, arena, cam), "jax": (js, jf, ja),
        "surface": surface, "normal_metallic": np.asarray(
            gbuf["normal_metallic"]), "lut": lut, "jax_frames": jframes,
    }


def _pixels(n):
    px = np.tile(np.arange(n), n)
    py = np.repeat(np.arange(n), n)
    return ((jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32)),
            (torch.as_tensor(px), torch.as_tensor(py)))


def _lights(case):
    jf = case["jax"][1]
    return jf["lights"], _t(case["numpy"][1]["lights"])


def _assert_reservoirs(got, want):
    """Light indices equal on >= 99.9% of the pixels; UCW rtol 1e-4
    where they agree."""
    (g_li, g_ucw), (w_li, w_ucw) = got, want
    g_li, w_li = g_li.numpy(), np.asarray(w_li)
    same = g_li == w_li
    assert same.mean() >= 0.999, (~same).sum()
    np.testing.assert_allclose(g_ucw.numpy()[same], np.asarray(w_ucw)[same],
                               rtol=1e-4, atol=0)
    return w_li


@pytest.mark.parametrize("frame_index", [0, 3])
def test_initial_reservoirs_match_jax(case, frame_index):
    s = case["surface"]
    (jpx, jpy), (tpx, tpy) = _pixels(case["n"])
    jl, tl = _lights(case)
    want = jrestir.initial_reservoirs(_jdev(s), jl, jpx, jpy, frame_index)
    got = restir.initial_reservoirs(_t(s), tl, tpx, tpy, frame_index)
    li = _assert_reservoirs(got, want)
    assert (li[s["valid"]] >= 0).mean() > 0.5  # most surfaces see a light
    assert (li > 0).any()  # point lights drawn, not only the sun


def _jax_reservoirs(case, frame_index):
    """The JAX initial reservoirs, masked by the G-buffer, and the
    neighbour rows packed from them."""
    s = case["surface"]
    (jpx, jpy), _ = _pixels(case["n"])
    jl, _ = _lights(case)
    li, ucw = jrestir.initial_reservoirs(_jdev(s), jl, jpx, jpy, frame_index)
    li = jnp.where(jnp.asarray(s["valid"]), li, -1)
    rows = jrestir.pack_neighbor_rows(
        {"linear_depth": jnp.asarray(s["linear_depth"]),
         "normal_metallic": jnp.asarray(case["normal_metallic"])}, li, ucw)
    return np.asarray(li), np.asarray(ucw), np.asarray(rows)


def test_pack_neighbor_rows_match_jax(case):
    li, ucw, want = _jax_reservoirs(case, 0)
    got = restir.pack_neighbor_rows(
        {"linear_depth": torch.as_tensor(case["surface"]["linear_depth"]),
         "normal_metallic": torch.as_tensor(case["normal_metallic"])},
        torch.as_tensor(li), torch.as_tensor(ucw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame_index", [0, 3])
def test_spatial_reuse_matches_jax(case, frame_index):
    s, n = case["surface"], case["n"]
    _, _, rows = _jax_reservoirs(case, frame_index)
    (jpx, jpy), (tpx, tpy) = _pixels(n)
    jl, tl = _lights(case)
    want = jrestir.spatial_reuse(_jdev(s), jl, jnp.asarray(rows), jpx, jpy,
                                 n, n, frame_index)
    got = restir.spatial_reuse(_t(s), tl, torch.as_tensor(rows), tpx, tpy, n,
                               n, frame_index)
    li = _assert_reservoirs(got, want)
    assert (li[s["valid"]] >= 0).any()


def test_uniform_sample_disk_matches_jax():
    u = np.random.default_rng(3).random((4096, 2)).astype(np.float32)
    want = np.asarray(jrestir._uniform_sample_disk(jnp.asarray(u)))
    got = restir._uniform_sample_disk(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (np.linalg.norm(got, axis=1) <= 1.0 + 1e-6).all()


def _port_scene(case, bvh):
    static, frame, arena, cam = case["numpy"]
    if not bvh:
        frame = {k: v for k, v in frame.items()
                 if k not in ("bvh_bounds", "bvh_meta")}
    return from_numpy_scene(static, frame, arena, "cpu"), camera_tensors(
        cam, "cpu")


@pytest.mark.parametrize("tracer", sorted(TRACERS))
def test_restir_shade_matches_jax(case, tracer, monkeypatch):
    """The traced shading of the JAX initial reservoirs (a light on most
    surfaces, so most pixels trace a shadow ray): the port's any-hit
    kernels (plain) against the JAX CPU tracer."""
    bvh, policy = TRACERS[tracer]
    monkeypatch.setattr(config.policy, "any_tracer", policy)
    s, n = case["surface"], case["n"]
    li, ucw, _ = _jax_reservoirs(case, 1)
    jl, tl = _lights(case)
    js, jf, _ = case["jax"]
    tris = jtrace.frame_geometry(js, jf)["tris"]
    want = np.asarray(jrestir.restir_shade(
        _jdev(s), jl, jnp.asarray(li), jnp.asarray(ucw), tris, jf))
    scene, _ = _port_scene(case, bvh)
    got, traced = restir.restir_shade(
        _t(s), tl, torch.as_tensor(li).long(), torch.as_tensor(ucw),
        restir.shadow_tracer(scene, n, n))
    got = got.numpy()
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert off.mean() <= 1e-3, off.sum()
    assert int(traced.sum()) > 0.05 * n * n
    lit = (want.sum(-1) > 0).sum()
    assert 0 < lit < int(traced.sum())  # some shadow rays are occluded


@pytest.mark.parametrize("tracer", sorted(TRACERS))
def test_restir_frames_match_jax(case, tracer, monkeypatch):
    """restir_entry frames 0 and 1 (accumulated) against the JAX CPU
    frames; the sample count and the shadow-ray count of the port."""
    bvh, policy = TRACERS[tracer]
    monkeypatch.setattr(config.policy, "any_tracer", policy)
    n = case["n"]
    scene, cam = _port_scene(case, bvh)
    run = partial(restir.restir_entry, scene=scene, cam=cam, lut=case["lut"],
                  width=n, height=n, device="cpu", return_stats=True)
    state = None
    for f, want in enumerate(case["jax_frames"]):
        img, state, n_shadow = run(frame_index=f, state=state)
        got = img.numpy()
        assert got.shape == want.shape == (n, n, 3)
        off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
        assert off.mean() <= 5e-3, (f, off.sum())
        assert np.isfinite(got).all()
        # at these sizes the 30 px reuse disk finds few neighbours that
        # pass, in the reference too: a few pixels keep a light
        assert 0 < int(n_shadow) <= n * n
    assert float(state[1].min()) == float(state[1].max()) == 2.0
