"""The forward mode, the transparent pass and the alpha-mask discard of
prosper_tpu_torch against prosper_tpu on the CPU, on the plate-64 scene
with blend and mask plates (testing.make_plate_scene(64, blend_every=8,
mask_every=8), 16 scattered lights) at 64x64.

The JAX package's CPU path traces with its XLA tracer over masked AABBs
and shades with the dense froxel lists; the port runs its kernels' plain
versions (K2 or K6, K4 or K8, K5).

Tolerances:
- integer outputs exact: alpha signals, debug hash colors, materials,
  instances, hit/miss; tri exact except exact t ties;
- sampled alpha, surfaces and debug AOVs within 1e-5 (1e-4 relative for
  positions): the same float32 expressions, in another order where XLA
  fuses; t within rtol 1e-5;
- frames: at most 0.5% of the pixels off by more than 1e-3 + 1e-3
  relative after the tone map, as tests/test_torch_deferred.py allows:
  the JAX and port frames shade the same light set per pixel in another
  summation order, the transparent pass's rays are made another way
  (pinhole_rays there, the G-buffer's affine camera uniforms here), and
  a pixel at a triangle edge may hit in one frame and miss in the other.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.mathx import rng as jrng
from prosper_tpu.ops import trace as jtrace
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.ops.texture import sample_alpha_packed as j_sample_alpha
from prosper_tpu.render import debug as jdebug
from prosper_tpu.render import forward as jforward
from prosper_tpu.render import surface as jsurface
from prosper_tpu.render.deferred import render_deferred as j_render_deferred
from prosper_tpu.render.gbuffer import mask_discard_retrace as j_retrace
from prosper_tpu.render.transparent import transparent_pass as j_transparent
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.mathx import rng as trng
from prosper_tpu_torch.ops import shade_tiles as tst
from prosper_tpu_torch.ops import trace as ttrace
from prosper_tpu_torch.ops import trace_bvh as ttb
from prosper_tpu_torch.ops import trace_flat as ttf
from prosper_tpu_torch.ops.slabs import unpack_hit8
from prosper_tpu_torch.ops.texture import sample_alpha_packed
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import debug as tdebug
from prosper_tpu_torch.render import forward as tforward
from prosper_tpu_torch.render import gbuffer as tgbuffer
from prosper_tpu_torch.render import surface as tsurface
from prosper_tpu_torch.render.deferred import deferred_entry
from prosper_tpu_torch.render.shading import eval_directional_light
from prosper_tpu_torch.render.transparent import (
    blend_cluster_mask,
    transparent_pass,
)
from prosper_tpu_torch.scene.convert import camera_tensors, from_numpy_scene
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
W = H = 64
LUT = pack_lut_quads(synthetic_lut())


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _j(t):
    return jnp.asarray(t.numpy())


def _no_bvh(frame):
    return {k: v for k, v in frame.items()
            if k not in ("bvh_bounds", "bvh_meta")}


@lru_cache(maxsize=1)
def _case():
    """numpy scene + camera, the JAX device scene, the port's scene with
    and without BVH arrays."""
    static, frame, arena, cam_fn = ttesting.make_plate_scene(
        64, 0, scatter_lights=16, blend_every=8, mask_every=8)
    cam = cam_fn(W, H)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    port = {"bvh": from_numpy_scene(static, frame, arena, "cpu"),
            "flat": from_numpy_scene(static, _no_bvh(frame), arena, "cpu")}
    return ((static, frame, arena, cam), (js, jf, ja, _jdev(cam)), port,
            camera_tensors(cam, "cpu"))


@pytest.fixture(scope="module")
def case():
    return _case()


def _forward_hits(case, row_major=True):
    """The forward pass's rays and their (R, 8) hit rows (K6 plain over
    the cluster AABBs), in row-major order."""
    _, _, port, tcam = case
    scene = port["bvh"]
    _, inverse = ttrace.block_order(W, H, "cpu")
    o, d = tforward.pixel_center_rays(tcam, W, H, "cpu")
    rows = ttf.trace_closest_flat(
        scene["geom"]["packed9"], scene["frame"]["wc_aabb_min_w"],
        scene["frame"]["wc_aabb_max_w"], o, d, 1e-4, float("inf"))
    if row_major:
        return o[inverse], d[inverse], rows[inverse]
    return o, d, rows


def _jhit(rows):
    return {"t": _j(rows[:, 0]), "tri": _j(rows[:, 1].to(torch.int32)),
            "u": _j(rows[:, 2]), "v": _j(rows[:, 3])}


def _frames_close(got, want, max_off=5e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all()
    off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
    assert off.mean() <= max_off, off.sum()


def test_sample_alpha_packed_matches_jax(case):
    """Every material at random uvs (outside [0, 1] too: REPEAT)."""
    _, (_, _, ja, _), port, _ = case
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 4, 4000).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (4000, 2)).astype(np.float32)
    want = np.asarray(j_sample_alpha(ja, jnp.asarray(mat), jnp.asarray(uv)))
    got = sample_alpha_packed(port["bvh"]["arena"], torch.as_tensor(mat),
                              torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # opaque -1; blend 0.5 (its base alpha); the mask's checker passes
    # and fails the cutoff
    assert (got[mat < 2] == -1).all()
    np.testing.assert_allclose(got[mat == 2], 0.5, atol=1e-6)
    masked = got[mat == 3]
    assert 0.2 < (masked == 0).mean() < 0.8 and ((masked == -1)
                                                  | (masked == 0)).all()


def test_uint_to_color_matches_jax():
    x = np.random.default_rng(2).integers(0, 2**32, 5000, dtype=np.uint64)
    x = x.astype(np.uint32)
    want = np.asarray(jrng.uint_to_color(jnp.asarray(x)))
    got = trng.uint_to_color(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_cone_lod_matches_jax():
    rng = np.random.default_rng(3)
    R = 3000
    d = rng.normal(size=(R, 3)).astype(np.float32)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = rng.uniform(0, 30, R).astype(np.float32)
    t[::13] = np.inf
    lod = rng.uniform(-8, 2, R).astype(np.float32)
    cone = {"alpha": 0.003, "bias": -1.0}
    want = np.asarray(jsurface.cone_lod(
        {"t": jnp.asarray(t), "tri_lod": jnp.asarray(lod)}, jnp.asarray(d),
        jnp.asarray(n), cone))
    got = tsurface.cone_lod(
        {"t": torch.as_tensor(t), "tri_lod": torch.as_tensor(lod)},
        torch.as_tensor(d), torch.as_tensor(n), cone).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _surfaces(case):
    (_, _, _, cam), (js, jf, ja, jcam), port, tcam = case
    o, d, rows = _forward_hits(case)
    cone = {"alpha": tsurface.pixel_cone_alpha(tcam, H), "bias": 0.0,
            "aniso_taps": 1}
    scene = port["bvh"]
    got = tsurface.evaluate_surface(scene["static"], scene["frame"],
                                    scene["arena"], o, d, unpack_hit8(rows),
                                    cone=cone)
    jcone = {"alpha": jsurface.pixel_cone_alpha(jcam, H), "bias": 0.0,
             "aniso_taps": 1}
    want = jsurface.evaluate_surface(js, jf, ja, _j(o), _j(d), _jhit(rows),
                                     cone=jcone)
    return got, want, rows


def test_evaluate_surface_matches_jax(case):
    got, want, rows = _surfaces(case)
    assert sorted(got) == sorted(want)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert 0.2 < valid.mean() < 0.9
    for k in ("material", "instance"):
        np.testing.assert_array_equal(got[k].numpy()[valid],
                                      np.asarray(want[k])[valid], err_msg=k)
    for k in ("normal_ws", "uv", "albedo", "alpha", "roughness", "metallic",
              "inv_view_ray", "NoV", "linear_depth"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["position_ws"].numpy()[valid],
                               np.asarray(want["position_ws"])[valid],
                               rtol=1e-4, atol=1e-4)
    # all four materials are on screen, the mask's alpha signals both ways
    mats = got["material"].numpy()[valid]
    assert set(np.unique(mats)) == {0, 1, 2, 3}
    alpha = got["alpha"].numpy()[valid]
    assert (alpha[mats == 3] == 0).any() and (alpha[mats == 3] == -1).any()


def test_evaluate_surface_refuses_what_the_base_mip_cannot_honour(case):
    """What the base-mip port refused it now samples: anisotropic taps
    (aniso_taps 4) equal JAX's on the same hits, within 1e-5; and a table
    that claims more mips than a texture holds clamps to its last mip,
    so the surfaces equal the one-mip arena's within 1e-6 (the trilinear
    blend of two equal taps)."""
    (_, (js, jf, ja, _), port, _) = case
    scene = port["bvh"]
    o, d, rows = _forward_hits(case)
    args = (scene["static"], scene["frame"], scene["arena"], o, d,
            unpack_hit8(rows))
    cone = {"alpha": 1e-3, "bias": 0.0, "aniso_taps": 4}
    got = tsurface.evaluate_surface(*args, cone=cone)
    want = jsurface.evaluate_surface(js, jf, ja, _j(o), _j(d), _jhit(rows),
                                     cone=cone)
    valid = np.asarray(want["valid"])
    for k in ("albedo", "alpha", "roughness", "metallic", "normal_ws"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    multi = dict(scene["arena"], n_mips=torch.tensor([1, 3]), one_mip=False)
    base = tsurface.evaluate_surface(*args, cone={"alpha": 1e-3})
    more = tsurface.evaluate_surface(*args[:2], multi, *args[3:],
                                     cone={"alpha": 1e-3})
    for k in ("albedo", "alpha", "roughness", "metallic"):
        torch.testing.assert_close(more[k], base[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("draw_type", list(tdebug.DrawType)[1:])
def test_debug_color_matches_jax(case, draw_type):
    got, want, rows = _surfaces(case)
    (js, _, _, _) = case[1]
    static = case[2]["bvh"]["static"]
    g = tdebug.debug_color(draw_type, got, unpack_hit8(rows), static)
    w = jdebug.debug_color(jdebug.DrawType(int(draw_type)), want,
                           _jhit(rows), js)
    valid = np.asarray(want["valid"])
    np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid],
                               rtol=1e-4, atol=1e-5)


def test_mask_discard_retrace_matches_jax(case):
    """Two rounds on the forward rays' hits: the same hits as JAX's, and
    some rays see through a mask plate."""
    (_, _, _, _), (js, jf, ja, _), port, _ = case
    scene = port["bvh"]
    o, d, rows = _forward_hits(case, row_major=False)
    mn, mx = scene["frame"]["wc_aabb_min_w"], scene["frame"]["wc_aabb_max_w"]
    closest, _ = ttrace.make_tracer(scene["geom"]["packed9"], mn, mx)
    got = tgbuffer.mask_discard_retrace(scene["arena"], scene["static"],
                                        closest, o, d, rows, 2)
    tris = {k: jnp.asarray(v.numpy()) for k, v in scene["geom"]["tris"].items()}
    jfn = jax.tree_util.Partial(jtrace.trace_closest, tris, _j(mn), _j(mx))
    want = j_retrace(ja, js, jfn, _j(o), _j(d), _jhit(rows), 2)
    g, w_tri = got.numpy(), np.asarray(want["tri"])
    np.testing.assert_array_equal(g[:, 1] >= 0, w_tri >= 0)
    both = w_tri >= 0
    tie = np.abs(g[both, 0] - np.asarray(want["t"])[both]) <= 1e-6 * g[both, 0]
    assert ((g[both, 1] == w_tri[both]) | tie).all()
    np.testing.assert_allclose(g[both, 0], np.asarray(want["t"])[both],
                               rtol=1e-5)
    changed = got[:, 1] != rows[:, 1]
    assert 0 < int(changed.sum()) < rows.shape[0] // 4
    # the full-row form gives the same hits
    full = ttf.trace_closest_flat_full(scene["geom"]["packed_full"], mn, mx,
                                       o, d, 1e-4, float("inf"))
    fclosest = lambda *a: ttf.trace_closest_flat_full(  # noqa: E731
        scene["geom"]["packed_full"], mn, mx, *a)
    got16 = tgbuffer.mask_discard_retrace(scene["arena"], scene["static"],
                                          fclosest, o, d, full, 2)
    torch.testing.assert_close(got16[:, :2], got[:, :2], rtol=0, atol=0)


def _opaque_z(case):
    """An opaque view-space z per pixel: nothing in front (-inf) on even
    pixels, a plane through the middle of the blend surfaces on odd
    ones, so the pass both blends and rejects."""
    _, _, port, tcam = case
    scene = port["bvh"]
    cols = tgbuffer._row_pixels(W, H, "cpu")
    _, o, d, _ = ttb.gbuffer_rays(tcam, W, H, cols)
    o, d = o[: W * H].contiguous(), d[: W * H]
    h = tgbuffer.full_tracer(scene, W, H)(blend_cluster_mask(scene))(
        o, d, 1e-4, float("inf"))
    w2c = tcam["world_to_camera"]
    z = ((o + h[:, :1] * d) @ w2c[2, :3] + w2c[2, 3])[h[:, 1] >= 0]
    plane = torch.full((W * H,), float(z.median()))
    plane[::2] = float("-inf")
    return plane


@pytest.mark.parametrize("branch", ["bvh", "flat"])
def test_transparent_pass_matches_jax(case, branch):
    """K4 with the blend mask as skip mask (BVH frame) and K8 over the
    masked AABBs (no BVH arrays), each against the JAX CPU path (the XLA
    tracer over masked AABBs)."""
    _, (js, jf, ja, jcam), port, tcam = case
    hdr = torch.as_tensor(np.random.default_rng(4).uniform(
        0, 1, (H, W, 3)).astype(np.float32))
    z = _opaque_z(case)
    got = transparent_pass(port[branch], tcam, hdr, z, W, H)
    want = j_transparent(js, jf, ja, jcam, _j(hdr), _j(z), W, H)
    _frames_close(got.numpy(), want)
    blended = (got - hdr).abs().amax(-1) > 1e-6
    assert 0.01 < float(blended.float().mean()) < 0.5
    # the IBL term, which raised before it was ported, lights the blend
    # surfaces (tests/test_torch_ibl.py holds it against JAX)
    from tests.test_torch_ibl import small_ibl
    from prosper_tpu_torch.ops.ibl import procedural_sky

    lit = transparent_pass(port[branch], tcam, hdr, z, W, H,
                           ibl_data=small_ibl(procedural_sky(4)))
    assert bool(torch.isfinite(lit).all())
    assert float((lit - got)[blended].abs().amax()) > 1e-3
    assert torch.equal(lit[~blended], got[~blended])


def test_transparent_k4_branch_matches_pallas(case):
    """The transparent pass's trace on a BVH frame, K4 with the blend
    clusters as skip mask (its plain version), against the JAX package's
    Pallas kernel with the same skip mask in interpret mode: the branch
    its own tests never ran on the CPU."""
    _, _, port, tcam = case
    scene = port["bvh"]
    w, h = 48, 40
    cols = tgbuffer._row_pixels(w, h, "cpu")
    _, o, d, _ = ttb.gbuffer_rays(tcam, w, h, cols)
    o, d = o[: w * h].contiguous(), d[: w * h].contiguous()
    mask = blend_cluster_mask(scene)
    args = (scene["geom"]["packed_full"], scene["frame"]["bvh_bounds"],
            scene["frame"]["bvh_meta"])
    got = ttb.trace_closest_bvh_full(*args, o, d, 1e-4, float("inf"),
                                     skip_mask=mask)
    with interpret_mode():
        want = jtb.trace_closest_bvh_full(
            *(_j(a) for a in args), _j(o), _j(d), 1e-4, jnp.inf,
            skip_mask=_j(mask))
    g, w_tri = got.numpy(), np.asarray(want["tri"])
    np.testing.assert_array_equal(g[:, 1], w_tri)
    hit = w_tri >= 0
    assert hit.any() and mask.numpy()[w_tri[hit] // 128].all()
    np.testing.assert_allclose(g[hit, 0], np.asarray(want["t"])[hit],
                               rtol=1e-5)
    for cols_, k in ((slice(2, 5), "normal"), (slice(5, 9), "tangent"),
                     (slice(9, 11), "uv")):
        np.testing.assert_allclose(g[hit][:, cols_],
                                   np.asarray(want[k])[hit], atol=1e-4)


@lru_cache(maxsize=None)
def _j_forward(use_transparent, alpha_rounds, draw_type):
    _, (js, jf, ja, jcam), _, _ = _case()
    return np.asarray(jforward.render_forward(
        js, jf, ja, jcam, jnp.asarray(LUT), W, H, 1.0, 1.0, draw_type,
        use_transparent, alpha_rounds))


@pytest.mark.parametrize("use_transparent,draw_type,branch", [
    (False, 0, "bvh"), (True, 0, "bvh"), (False, 0, "flat"),
    (True, 0, "flat"), (False, 6, "bvh"), (True, 2, "bvh"),
])
def test_forward_frame_matches_jax(case, use_transparent, draw_type, branch):
    """The whole forward frame with the CLI's flags (two alpha rounds on
    this scene; the transparent pass on or off) against render_forward."""
    _, _, port, tcam = case
    want = _j_forward(use_transparent, 2, draw_type)
    got, state = tforward.forward_entry(
        scene=port[branch], cam=tcam, lut=LUT, width=W, height=H,
        device="cpu", draw_type=draw_type, use_transparent=use_transparent,
        alpha_rounds=2)
    _frames_close(got.numpy(), want)
    assert 0 < int(state["covered_pixels"]) < W * H


def test_alpha_discard_and_blend_change_the_forward_frame(case):
    """The scene exercises both: the alpha rounds uncover pixels behind
    mask plates, and the transparent pass tints pixels."""
    _, _, port, tcam = case
    run = lambda **kw: tforward.render_forward(  # noqa: E731
        port["bvh"], tcam, torch.as_tensor(LUT), W, H, **kw)
    base, n0 = run()
    masked, n2 = run(alpha_rounds=2)
    blended, _ = run(alpha_rounds=2, use_transparent=True)
    assert int(n2) != int(n0)
    assert ((masked - base).abs().amax(-1) > 1e-3).float().mean() > 0.01
    assert ((blended - masked).abs().amax(-1) > 1e-3).float().mean() > 0.01


def test_eval_all_lights_matches_jax_and_the_clustered_path(case):
    """The O(pixels x lights) reference against JAX's, and the clustered
    path of the frame (sun + K5's plain version) against it."""
    got, want, _ = _surfaces(case)
    lights = case[2]["bvh"]["frame"]["lights"]
    jl = case[1][1]["lights"]
    valid = got["valid"]
    surf = dict(got, position_ws=torch.where(valid[:, None],
                                             got["position_ws"], 0.0))
    ref = tforward.eval_all_lights(surf, lights)
    jsurf = dict(want, position_ws=_j(surf["position_ws"]))
    np.testing.assert_allclose(ref.numpy()[valid.numpy()],
                               np.asarray(jforward.eval_all_lights(
                                   jsurf, jl))[valid.numpy()],
                               rtol=1e-4, atol=1e-6)
    tcam = case[3]
    w2c = tcam["world_to_camera"]
    z = torch.where(valid, surf["position_ws"] @ w2c[2, :3] + w2c[2, 3],
                    float("-inf"))
    clustered = eval_directional_light(surf, lights) + tst.shade_clustered_tiles(
        tst.tile_inputs(surf, lights, tcam, z, valid, W, H), W, H)
    torch.testing.assert_close(clustered[valid], ref[valid], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("use_culling", [False, True])
def test_deferred_transparent_alpha_without_bvh_matches_jax(case,
                                                            use_culling):
    """The deferred frame with the transparent pass and two alpha rounds
    on a frame without BVH arrays (K8 for the G-buffer, its culling
    phases, the retrace and the transparent pass) against JAX's."""
    (_, frame, _, _), (js, jf, ja, jcam), port, tcam = case
    want, _ = j_render_deferred(js, _jdev(_no_bvh(frame)), ja, jcam,
                                jnp.asarray(LUT), W, H,
                                use_culling=use_culling,
                                use_transparent=True, alpha_rounds=2)
    got, state = deferred_entry(scene=port["flat"], cam=tcam, lut=LUT,
                                width=W, height=H, device="cpu",
                                use_culling=use_culling, use_transparent=True,
                                alpha_rounds=2)
    _frames_close(got.numpy(), want)
    # and equal to the frame of the same scene with its BVH arrays
    same, _ = deferred_entry(scene=port["bvh"], cam=tcam, lut=LUT, width=W,
                             height=H, device="cpu", use_culling=use_culling,
                             use_transparent=True, alpha_rounds=2)
    torch.testing.assert_close(got, same, rtol=0, atol=1e-6)


def test_entry_defaults_follow_the_cli():
    """use_transparent and alpha_rounds default as the CLI sets them: on
    for the blend/mask scene, off for the opaque one."""
    seen = []
    real = tforward.render_forward

    def spy(*a, **kw):
        seen.append((kw["use_transparent"], kw["alpha_rounds"]))
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tforward, "render_forward", spy)
        for kw in ({}, {"blend_every": 8, "mask_every": 8}):
            fn, args = entry("cpu", scene="plate", n_clusters=8, width=32,
                             height=32, mode="forward", **kw)
            fn(*args)
    assert seen == [(False, 0), (True, 2)]
    # the path tracer renders without BVH arrays too (K8 and K7)
    fn, args = entry("cpu", scene="plate", n_clusters=8, width=32, height=32,
                     mode="pt", bvh=False)
    img, _, n_rays = fn(*args)
    assert bool(torch.isfinite(img).all()) and int(n_rays) > 32 * 32
