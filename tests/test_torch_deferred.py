"""The deferred path of prosper_tpu_torch against prosper_tpu on the CPU:
meshlet culling and the HiZ pyramid, the G-buffer, two-phase culling and
the whole deferred frame.

Tolerances:
- masks, counts and the HiZ mips exact (the same float32 expressions on
  the same inputs, and min reductions);
- G-buffer: `valid` exact; the encodings within 1e-5 (position, view z
  1e-4 relative). The JAX CPU G-buffer makes its rays as uv + jitter
  through `pinhole_rays` and traces them with the XLA tracer; the port
  makes them with the primary kernel's affine camera uniforms and traces
  with the kernels' plain versions, so the hit points differ by float32
  rounding of the ray directions;
- deferred frame: at most 0.5% of the pixels off by more than 1e-3 +
  1e-3 relative after the tone map. The JAX CPU frame shades with the
  dense froxel lists (`eval_clustered_lights`), the port with the tile
  kernel's plain version; both shade the same light set per pixel, in
  another summation order, and a pixel at a triangle edge may hit in one
  frame and miss in the other.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import culling as jculling
from prosper_tpu.ops import hiz as jhiz
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render.deferred import render_deferred as j_render_deferred
from prosper_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import culling as tculling
from prosper_tpu_torch.ops import hiz as thiz
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render.deferred import deferred_entry
from prosper_tpu_torch.render.gbuffer import render_gbuffer
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene

torch.set_num_threads(2)
W = H = 64

SCENES = {
    "boxes": lambda: ttesting.make_test_scene(4),
    "plate": lambda: ttesting.make_plate_scene(27, 1, scatter_lights=64),
}

_j_gbuffer = jax.jit(j_render_gbuffer,
                     static_argnames=("width", "height", "use_culling"))


def _jdev(tree):
    return {
        k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
        for k, v in tree.items()
    }


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    """(name, numpy scene + camera, JAX device scene, port scene)."""
    static, frame, arena, cam_fn = SCENES[request.param]()
    cam = cam_fn(W, H)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    return (request.param, (static, frame, cam), (js, jf, ja, _jdev(cam)),
            (scene, camera_tensors(cam, "cpu")))


def _prev_hiz(kind, depth):
    """A previous frame's HiZ: none, a real one, or the adversarial
    all-near one of tests/test_two_phase.py (everything reads occluded)."""
    if kind == "none":
        return None
    if kind == "near":
        depth = np.full((H, W), 0.999, np.float32)
    return thiz.build_hiz(torch.as_tensor(depth), W, H)


def _gbuffer_depth(case):
    scene, tcam = case[3]
    return render_gbuffer(scene, tcam, W, H)["depth"].reshape(H, W).numpy()


@pytest.mark.parametrize("width,height", [(64, 64), (100, 60), (34, 18)])
def test_build_hiz_equals_jax(width, height):
    depth = np.random.default_rng(width).uniform(0, 1, (height, width))
    depth = depth.astype(np.float32)
    depth[::7] = 0.0  # background rows
    want = jhiz.build_hiz(jnp.asarray(depth), width, height)
    got = thiz.build_hiz(torch.as_tensor(depth), width, height)
    assert thiz.hiz_dimensions(width, height) == jhiz.hiz_dimensions(
        width, height)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hiz_kind", ["none", "real", "near"])
def test_cull_clusters_equal_jax(case, hiz_kind):
    """Both phases' masks and counts, exactly; the adversarial HiZ
    occludes at least one cluster."""
    _, (static, frame, cam), (js, jf, _, jcam), (scene, tcam) = case
    prev = _prev_hiz(hiz_kind, _gbuffer_depth(case))
    scales_j = jnp.linalg.norm(jf["transforms"][:, :, :3], axis=1).max(-1)
    want = jculling.cull_clusters(
        js, jf, jcam, scales_j,
        [jnp.asarray(m.numpy()) for m in prev] if prev else [], W, H,
        output_second_phase=True,
    )
    scales_t = torch.as_tensor(np.array(scales_j))
    got = tculling.cull_clusters(scene["static"], scene["frame"], tcam,
                                 scales_t, prev or [], W, H,
                                 output_second_phase=True)
    for k in ("visible", "second_phase"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("visible_count", "drawn_meshlets", "rasterized_triangles",
              "second_phase_count"):
        assert int(got[k]) == int(want[k]), k
    if hiz_kind == "near":
        assert int(got["second_phase_count"]) > 0


@pytest.mark.parametrize("width,height", [(64, 64), (100, 60)])
def test_sphere_occluded_equals_jax(width, height):
    """Random spheres of every size in front of and behind the camera
    against a random HiZ: the same occlusion, at every mip."""
    static, frame, arena, cam_fn = SCENES["boxes"]()
    cam = cam_fn(width, height)
    rng = np.random.default_rng(width)
    n = 4000
    eye, fwd = cam["eye"], -cam["world_to_camera"][2, :3]
    center = (eye + fwd * rng.uniform(-2, 12, (n, 1))
              + rng.normal(0, 3, (n, 3))).astype(np.float32)
    radius = np.exp(rng.uniform(-5, 1, n)).astype(np.float32)
    depth = rng.uniform(0.0, 0.2, (height, width)).astype(np.float32)
    mips = thiz.build_hiz(torch.as_tensor(depth), width, height)
    want = np.asarray(jculling.sphere_occluded(
        jnp.asarray(center), jnp.asarray(radius), _jdev(cam),
        [jnp.asarray(m.numpy()) for m in mips], width, height))
    got = tculling.sphere_occluded(
        torch.as_tensor(center), torch.as_tensor(radius),
        camera_tensors(cam, "cpu"), mips, width, height).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95


def test_cull_helpers_equal_jax(case):
    """transform_cluster_bounds, sphere_outside_frustum, cone_cap_hidden
    and project_sphere_view on the scene's clusters."""
    _, _, (js, jf, _, jcam), (scene, tcam) = case
    scales_j = jnp.linalg.norm(jf["transforms"][:, :, :3], axis=1).max(-1)
    want = jculling.transform_cluster_bounds(js, jf, scales_j)
    got = tculling.transform_cluster_bounds(
        scene["static"], scene["frame"], torch.as_tensor(np.array(scales_j)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    center, radius, axis, cutoff = (jnp.asarray(g.numpy()) for g in got)
    tc, tr, ta, tcut = got
    np.testing.assert_array_equal(
        tculling.sphere_outside_frustum(tc, tr, tcam["frustum_planes"]),
        jculling.sphere_outside_frustum(center, radius,
                                        jcam["frustum_planes"]))
    np.testing.assert_array_equal(
        tculling.cone_cap_hidden(tc, tr, ta, tcut, tcam["eye"]),
        jculling.cone_cap_hidden(center, radius, axis, cutoff, jcam["eye"]))
    c = tc * torch.tensor([1.0, 1.0, -1.0]) + torch.tensor([0.0, 0.0, 5.0])
    p00, p11 = tcam["camera_to_clip"][0, 0], tcam["camera_to_clip"][1, 1]
    gv, ga = tculling.project_sphere_view(c, tr, tcam["near"], p00, p11)
    wv, wa = jculling.project_sphere_view(
        jnp.asarray(c.numpy()), radius, jcam["near"], jnp.asarray(p00),
        jnp.asarray(p11))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    sel = gv.numpy()
    np.testing.assert_allclose(ga.numpy()[sel], np.asarray(wa)[sel],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_culling", [False, True])
def test_gbuffer_matches_jax(case, use_culling):
    _, _, (js, jf, ja, jcam), (scene, tcam) = case
    want = _j_gbuffer(js, jf, ja, jcam, width=W, height=H,
                      use_culling=use_culling)
    got = render_gbuffer(scene, tcam, W, H, use_culling=use_culling)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert 0.05 < valid.mean() < 0.95
    for k, rtol, atol in (("albedo_roughness", 0, 1e-5),
                          ("normal_metallic", 0, 1e-5),
                          ("velocity", 0, 1e-5), ("depth", 0, 1e-5),
                          ("z_cam", 1e-4, 1e-5),
                          ("position_ws", 1e-4, 1e-4)):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=rtol,
                                   atol=atol, err_msg=k)
    assert (got["z_cam"].numpy()[~valid] == -np.inf).all()
    assert (got["depth"].numpy()[~valid] == 0).all()
    if use_culling:
        assert int(got["draw_stats"]["drawn_meshlets"]) == int(
            want["draw_stats"]["drawn_meshlets"])
        for g, w in zip(got["hiz"], want["hiz"]):
            assert g.shape == w.shape


@pytest.mark.parametrize("hiz_kind", ["none", "real", "near"])
def test_culled_gbuffer_equals_unculled(case, hiz_kind):
    """Culling is conservative: every output of the culled G-buffer
    equals the unculled one, whatever the previous HiZ says."""
    scene, tcam = case[3]
    base = render_gbuffer(scene, tcam, W, H)
    prev = _prev_hiz(hiz_kind, base["depth"].reshape(H, W).numpy())
    culled = render_gbuffer(scene, tcam, W, H, use_culling=True,
                            prev_hiz=prev)
    assert torch.equal(culled["valid"], base["valid"])
    torch.testing.assert_close(culled["depth"], base["depth"], rtol=0,
                               atol=1e-6)
    for k in ("albedo_roughness", "normal_metallic", "velocity", "z_cam",
              "position_ws"):
        assert torch.equal(culled[k], base[k]), k
    assert int(culled["draw_stats"]["drawn_meshlets"]) >= 1


@pytest.mark.parametrize("use_culling", [False, True])
def test_deferred_frame_matches_jax(case, use_culling):
    """deferred_entry against render_deferred, the same synthetic LUT."""
    name, _, (js, jf, ja, jcam), (scene, tcam) = case
    lut = pack_lut_quads(synthetic_lut())
    want, _ = j_render_deferred(js, jf, ja, jcam, jnp.asarray(lut), W, H,
                                use_culling=use_culling)
    got, state = deferred_entry(scene=scene, cam=tcam, lut=lut, width=W,
                                height=H, device="cpu",
                                use_culling=use_culling)
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == (H, W, 3)
    off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
    assert off.mean() <= 5e-3, off.sum()
    assert np.isfinite(got).all()
    # lit surfaces: the hit pixels are brighter than the background
    valid = state["depth"].numpy() > 0
    assert got[valid].mean() > got[~valid].mean()
    assert (state["hiz"] is not None) == use_culling


def test_two_frames_thread_the_hiz(case):
    """The second frame culls against the first frame's HiZ from the
    state and renders the same image; without culling no HiZ is kept."""
    scene, tcam = case[3]
    lut = pack_lut_quads(synthetic_lut())
    run = partial(deferred_entry, scene=scene, cam=tcam, lut=lut, width=W,
                  height=H, device="cpu", use_culling=True)
    img0, state0 = run()
    img1, state1 = run(state=state0, frame_index=1)
    assert torch.equal(img0, img1)
    assert len(state0["hiz"]) == len(state1["hiz"]) > 1
    for a, b in zip(state0["hiz"], state1["hiz"]):
        assert torch.equal(a, b)
    drawn0 = int(state0["draw_stats"]["drawn_meshlets"])
    drawn1 = int(state1["draw_stats"]["drawn_meshlets"])
    assert 1 <= drawn1 <= drawn0
    _, plain = deferred_entry(scene=scene, cam=tcam, lut=lut, width=W,
                              height=H, device="cpu", state=state1)
    assert plain["hiz"] is None and plain["draw_stats"] == {}


def test_unported_options_raise(case):
    """The post chain and IBL, which raised before they were ported, now
    render: each option gives a finite frame that differs from the plain
    one (tests/test_torch_post.py and test_torch_ibl.py hold them against
    JAX); an unknown bloom technique raises."""
    scene, tcam = case[3]
    lut = pack_lut_quads(synthetic_lut())
    # a wide aperture, so that DoF blurs
    tcam = {**tcam, "aperture_diameter": torch.tensor(0.5),
            "focus_distance": torch.tensor(6.0)}
    run = partial(deferred_entry, scene=scene, cam=tcam, lut=lut, width=W,
                  height=H, device="cpu")
    plain, _ = run()
    from tests.test_torch_ibl import small_ibl
    from prosper_tpu_torch.ops.ibl import procedural_sky

    for kw in ({"use_taa": True}, {"use_bloom": True}, {"use_dof": True},
               {"use_particles": True},
               {"ibl_data": small_ibl(procedural_sky(4))}):
        img, state = run(**kw)
        assert bool(torch.isfinite(img).all())
        if "use_particles" in kw:  # the emitters may all lie out of view
            pool = state["particles"]["position_lifetime"]
            assert int((pool[:, 3] >= 0).sum()) >= 1
        elif "use_taa" not in kw:  # a still camera: TAA keeps the frame
            assert float((img - plain).abs().amax()) > 1e-3, kw
    with pytest.raises(ValueError, match="bloom_technique"):
        run(use_bloom=True, bloom_technique="gaussian")
