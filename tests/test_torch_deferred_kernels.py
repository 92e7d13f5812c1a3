"""The deferred path's kernels, as their plain PyTorch versions
(prosper_tpu_torch.ops.trace_bvh, prosper_tpu_torch.ops.shade_tiles),
against the Pallas kernels of prosper_tpu run in interpret mode on the
CPU, and against the JAX package's XLA paths.

Tolerances:
- integer outputs exact: hit/miss and tri ids, the froxel tile lists and
  their counts;
- trace t within rtol 1e-5 and interpolated attributes within 1e-4 (the
  same float32 expressions, evaluated by XLA and by PyTorch);
- shaded color within rtol 2e-4 / atol 2e-4, the tolerance of
  tests/test_shade_tiles.py between the JAX package's own two paths,
  on all but 0.1% of the pixels, and within rtol 2e-3 on those: the
  Pallas kernel takes rsqrt and pow(x, 5) where the port writes 1 / sqrt
  and x^2 * x^2 * x, and XLA and PyTorch evaluate log, exp and the plane
  matmuls to within a few ulps of each other. On a very smooth surface
  (roughness 0.05, alpha^2 = 6e-6) the GGX term at a highlight turns an
  ulp of NoH into a relative error of ~1e-3 in D, in the JAX package's
  two paths as in the port: at 80x56, 2 of 4480 pixels differ by 1.4e-3
  relative from the Pallas kernel (and by 1e-3 from the XLA path).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import clustering as jclustering
from prosper_tpu.ops import shade_tiles as jst
from prosper_tpu.ops import trace as jtrace
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.scene import camera as jcamera
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.accel.bvh import build_bvh, pack_nodes
from prosper_tpu_torch.mathx import rng as prng
from prosper_tpu_torch.ops import shade_tiles as tst
from prosper_tpu_torch.ops import trace_bvh as ttb
from prosper_tpu_torch.scene import camera as tcamera
from prosper_tpu_torch.scene.convert import from_numpy_scene
from tests.test_shade_tiles import _make_case
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a), device="cpu")


def _tree(d):
    return {k: _t(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# K5: clustered tile shading


@pytest.fixture(scope="module", params=[(96, 64), (80, 56)],
                ids=["96x64", "80x56_ragged"])
def shade_case(request):
    width, height = request.param
    cam, lights, surface, z_cam, valid, px, py, w, h = _make_case(
        width=width, height=height
    )
    port = (_tree(cam), _tree(lights), _tree(surface), _t(z_cam), _t(valid))
    return (cam, lights, surface, z_cam, valid, px, py, w, h), port


def test_tile_light_lists_equal_jax(shade_case):
    (cam, lights, _, _, _, _, _, w, h), (tcam, tlights, *_) = shade_case
    lists, counts, vz = jst.build_tile_light_lists(cam, lights, w, h)
    got_lists, got_counts, got_vz = tst.build_tile_light_lists(
        tcam, tlights, w, h
    )
    np.testing.assert_array_equal(got_lists.numpy(), np.asarray(lists))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(counts))
    assert 0 < int(got_counts.max()) <= 40
    np.testing.assert_allclose(got_vz.numpy(), np.asarray(vz)[0],
                               rtol=1e-6, atol=1e-6)


def _assert_shade_close(got, want):
    bad = (np.abs(got - want) > 2e-4 + 2e-4 * np.abs(want)).any(axis=-1)
    assert bad.mean() <= 1e-3, bad.sum()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _port_shade(port, w, h, **kw):
    tcam, tlights, tsurface, tz, tvalid = port
    inp = tst.tile_inputs(tsurface, tlights, tcam, tz, tvalid, w, h)
    return tst.shade_clustered_tiles_plain(inp, w, h, **kw)


def test_shade_plain_matches_pallas_kernel(shade_case):
    (cam, lights, surface, z_cam, valid, _, _, w, h), port = shade_case
    with interpret_mode():
        want = np.asarray(jst.shade_clustered_tiles(
            surface, lights, cam, z_cam, valid, w, h
        ))
    tcam, tlights, tsurface, tz, tvalid = port
    got = tst.shade_clustered_tiles(
        tst.tile_inputs(tsurface, tlights, tcam, tz, tvalid, w, h), w, h
    ).numpy()
    assert got.shape == want.shape == (w * h, 3)
    assert (want[np.asarray(valid)] > 0).any(axis=-1).mean() > 0.5
    _assert_shade_close(got, want)
    assert (got[~np.asarray(valid)] == 0).all()


def test_shade_plain_matches_froxel_path(shade_case):
    """Against clustering.build_light_clusters + eval_clustered_lights,
    the JAX package's CPU path (the dense per-froxel lists)."""
    (cam, lights, surface, z_cam, valid, px, py, w, h), port = shade_case
    clusters = jclustering.build_light_clusters(cam, lights, w, h)
    want = jclustering.eval_clustered_lights(
        surface, lights, clusters, px, py, z_cam, cam["near"], cam["far"]
    )
    want = np.where(np.asarray(valid)[:, None], np.asarray(want), 0.0)
    got, cnt, needed = _port_shade(port, w, h, return_counts=True)
    _assert_shade_close(got.numpy(), want)
    # the running count is the froxel's uncapped visible-light count
    fz = np.asarray(jclustering.cluster_index_z(z_cam, cam["near"],
                                                cam["far"]))
    fx, fy = np.asarray(px) // 32, np.asarray(py) // 32
    vis_all = np.asarray(clusters["point_counts"])[fx, fy, fz]
    sel = np.asarray(valid)
    np.testing.assert_array_equal(np.minimum(cnt.numpy(), 128)[sel],
                                  vis_all[sel])
    # below the cap every listed light's test is needed
    assert int(cnt.max()) < 128
    tiles = (np.asarray(py) // 32) * (-(-w // 32)) + np.asarray(px) // 32
    counts = tst.build_tile_light_lists(port[0], port[1], w, h)[1].numpy()
    np.testing.assert_array_equal(needed.numpy(), counts[tiles])


def test_shade_cap_keeps_the_first_128_visible_lights():
    """With more visible lights than the cap, only the first 128 in
    ascending order are shaded: the result equals that of a light table
    holding just those 128."""
    cam, lights, surface, z_cam, valid, _, _, w, h = _make_case(
        width=64, height=32, n_point=200, n_spot=0, seed=3
    )
    tcam, tlights, tsurface = _tree(cam), _tree(lights), _tree(surface)
    tlights["point_radius"][:200] = 100.0  # every light reaches every pixel
    tlights["packed_rows"][1:201, 7] = 100.0
    inp = tst.tile_inputs(tsurface, tlights, tcam, _t(z_cam), _t(valid), w, h)
    assert int(inp["counts"].min()) == 200
    got, cnt, needed = tst.shade_clustered_tiles_plain(inp, w, h,
                                                       return_counts=True)
    assert float(cnt.min()) == 200.0
    # all 200 are visible everywhere: the 128th is the 128th listed
    assert (needed == 128).all()
    tlights["point_count"] = torch.tensor(128, dtype=torch.int32)
    inp128 = tst.tile_inputs(tsurface, tlights, tcam, _t(z_cam), _t(valid),
                             w, h)
    want = tst.shade_clustered_tiles_plain(inp128, w, h)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_shade_wrapper_dispatch():
    """CPU tensors take the plain version and leave the launch count
    alone; a device that is neither CPU nor CUDA is refused."""
    cam, lights, surface, z_cam, valid, _, _, w, h = _make_case(32, 32, 4, 1)
    inp = tst.tile_inputs(_tree(surface), _tree(lights), _tree(cam),
                          _t(z_cam), _t(valid), w, h)
    tst.shade_clustered_tiles.launches = 0
    tst.shade_clustered_tiles(inp, w, h)
    assert tst.shade_clustered_tiles.launches == 0
    meta = {k: v.to("meta") for k, v in inp.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tst.shade_clustered_tiles(meta, w, h)


# ---------------------------------------------------------------------------
# K4: closest hit with attributes and a cluster skip mask


def _plate_rays(n_clusters=12, seed=2, R=512):
    static, frame, arena, cam_fn = ttesting.make_plate_scene(n_clusters, seed)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(seed)
    eye = cam_fn(32, 32)["eye"]
    lo, hi = frame["wc_aabb_min_w"].min(0), frame["wc_aabb_max_w"].max(0)
    target = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    o = np.broadcast_to(eye, (R, 3)).astype(np.float32).copy()
    o[::3] = rng.uniform(lo, hi, (len(o[::3]), 3))  # rays from inside too
    d = target - o + rng.normal(0, 0.05, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(R, np.inf, np.float32)
    t_max[::11] = 0.0
    t_max[1::11] = 2.0
    mask = rng.random(n_clusters) > 0.4
    return scene, frame, o, d.astype(np.float32), t_max, mask


def _assert_full_rows(got, want):
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    sel = want[:, 1] >= 0
    assert sel.mean() > 0.1 and not sel.all()
    np.testing.assert_allclose(got[sel, 0], want[sel, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 2:13], want[:, 2:13], atol=1e-4)


def test_closest_full_plain_matches_pallas_with_mask():
    scene, frame, o, d, t_max, mask = _plate_rays()
    packed = scene["geom"]["packed_full"].numpy()
    with interpret_mode():
        want = np.asarray(jtb.trace_closest_bvh_full(
            jnp.asarray(packed), jnp.asarray(frame["bvh_bounds"]),
            jnp.asarray(frame["bvh_meta"]), jnp.asarray(o), jnp.asarray(d),
            1e-4, jnp.asarray(t_max), packed=True,
            skip_mask=jnp.asarray(mask),
        ))
    got = ttb.trace_closest_bvh_full(
        scene["geom"]["packed_full"], _t(frame["bvh_bounds"]),
        _t(frame["bvh_meta"]), _t(o), _t(d), 1e-4, _t(t_max),
        skip_mask=_t(mask),
    ).numpy()
    _assert_full_rows(got, want)
    # no hit on a masked cluster
    tri = got[:, 1].astype(np.int64)
    assert mask[tri[tri >= 0] // 128].all()


def test_closest_full_plain_equals_brute_force_over_unmasked():
    """The masked trace equals a trace of a scene that holds only the
    unmasked clusters (their own BVH), tri ids mapped back: masking a
    cluster is removing it."""
    scene, frame, o, d, t_max, mask = _plate_rays(seed=5)
    slabs = scene["geom"]["packed_full"]
    got = ttb.trace_closest_bvh_full(
        slabs, _t(frame["bvh_bounds"]), _t(frame["bvh_meta"]), _t(o), _t(d),
        1e-4, _t(t_max), skip_mask=_t(mask),
    ).numpy()
    kept = np.nonzero(mask)[0]
    bounds, meta = pack_nodes(build_bvh(frame["wc_aabb_min_w"][kept],
                                        frame["wc_aabb_max_w"][kept],
                                        max_leaf_size=1))
    sub = ttb.trace_closest_bvh_full(
        slabs[torch.as_tensor(kept)].contiguous(), _t(bounds), _t(meta),
        _t(o), _t(d), 1e-4, _t(t_max),
    ).numpy()
    tri = sub[:, 1].astype(np.int64)
    sub[:, 1] = np.where(tri >= 0, kept[tri // 128] * 128 + tri % 128, -1)
    np.testing.assert_array_equal(got, sub)
    unmasked = ttb.trace_closest_bvh_full(
        slabs, _t(frame["bvh_bounds"]), _t(frame["bvh_meta"]), _t(o), _t(d),
        1e-4, _t(t_max),
    ).numpy()
    assert (unmasked[:, 1] != got[:, 1]).any()  # the mask changed hits


# ---------------------------------------------------------------------------
# K1: the G-buffer form and the path tracer's form


def _jittered_cameras(width, height, jitter_index=3):
    eye = np.array([4.0, 3.5, 4.5], np.float32)
    target = np.array([0.0, 0.3, 0.0], np.float32)
    jc = jcamera.Camera((width, height), jcamera.CameraParameters(),
                        jcamera.CameraTransform(eye=eye, target=target),
                        apply_jitter=True)
    tc = tcamera.Camera((width, height), tcamera.CameraParameters(),
                        tcamera.CameraTransform(eye=eye.copy(),
                                                target=target.copy()),
                        apply_jitter=True)
    for c in (jc, tc):
        c._jitter_index = jitter_index
        c.update()
    return jc.uniforms(), tc.uniforms()


def test_primary_gbuffer_form_matches_pallas():
    """K1 with the TAA pixel offset (pcg_on = 0) on the box scene at
    48x40 in row-major pixel order: tri exact, t rtol 1e-5, attributes
    1e-4; the pad lanes are dead misses."""
    W, H = 48, 40
    static, frame, arena, _ = ttesting.make_test_scene(4)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    jcam, tcam = _jittered_cameras(W, H)
    assert (jcam["current_jitter"] != 0).all()
    jvec = jtb.primary_cam_vec({k: jnp.asarray(v) for k, v in jcam.items()},
                               W, H, pixel_jitter=jcam["current_jitter"])
    tvec = ttb.primary_cam_vec(tcam, W, H, pixel_jitter=tcam["current_jitter"])
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), rtol=1e-6,
                               atol=1e-7)
    assert float(tvec[0, 16]) == 0.0 and float(tvec[0, 14]) != 0.5
    px = np.tile(np.arange(W), H)
    py = np.repeat(np.arange(H), W)
    cols, rows, R0 = jtb.pack_pixels_np(px, py)
    packed = scene["geom"]["packed_full"]
    with interpret_mode():
        want = np.asarray(jtb.trace_primary_bvh_full(
            jnp.asarray(packed.numpy()), jnp.asarray(frame["bvh_bounds"]),
            jnp.asarray(frame["bvh_meta"]), jnp.asarray(cols),
            jnp.asarray(rows), jvec, jnp.array([[5, 0, 0, 0]], jnp.int32),
        ))
    got = ttb.trace_primary_bvh_full(
        packed, _t(frame["bvh_bounds"]), _t(frame["bvh_meta"]), _t(cols),
        tvec, 5, 1e-4,
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    sel = want[:, 1] >= 0
    assert 0.05 < sel[:R0].mean() < 0.95
    np.testing.assert_allclose(got[sel, 0], want[sel, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 2:13], want[:, 2:13], atol=1e-4)
    assert (got[R0:, 1] == -1.0).all() and (got[R0:, 0] == 0.0).all()
    # the G-buffer's rays skip the jitter's hash: the same uniforms and
    # the same rays, bit for bit
    gvec, o1, d1, _ = ttb.gbuffer_rays(tcam, W, H, _t(cols))
    o0, d0, _ = ttb.raygen_plain(_t(cols), tvec, 5)
    assert torch.equal(gvec, tvec)
    assert torch.equal(o0, o1) and torch.equal(d0, d1)


def test_primary_pt_form_unchanged():
    """pcg_on = 1, offsets 0: the rays are bit for bit the ones of the
    path tracer's raygen ux = (px + jx) / W, and K1's rows are the
    brute-force closest hit of those rays with its attributes."""
    W, H = 32, 32
    static, frame, arena, cam_fn = ttesting.make_test_scene(4)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    cam = cam_fn(W, H)
    px, py, _ = jtrace.block_pixel_order(W, H)
    cols = _t(ttb.pack_pixels_np(px, py)[0])
    vec = ttb.primary_cam_vec(cam, W, H)
    assert vec[0, 14:17].tolist() == [0.0, 0.0, 1.0]
    o, d, tmax = ttb.raygen_plain(cols, vec, 7)
    # the raygen of the path tracer before the G-buffer offsets existed
    cpx, cpy = cols[:, 0, :].reshape(-1), cols[:, 1, :].reshape(-1)
    _, jit = prng.rnd2d01(prng.make_state(cpx.long(), cpy.long(), 7))
    c = vec[0]
    ux, uy = (cpx + jit[:, 0]) / c[12], (cpy + jit[:, 1]) / c[13]
    d_old = ux[:, None] * c[3:6] + uy[:, None] * c[6:9] + c[9:12]
    d_old = d_old * (1.0 / torch.sqrt(
        d_old[:, 0] * d_old[:, 0] + d_old[:, 1] * d_old[:, 1]
        + d_old[:, 2] * d_old[:, 2]))[:, None]
    assert torch.equal(d, d_old)
    packed = scene["geom"]["packed_full"]
    bounds, meta = _t(frame["bvh_bounds"]), _t(frame["bvh_meta"])
    got = ttb.trace_primary_bvh_full(packed, bounds, meta, cols, vec, 7, 0.0)
    want = ttb.trace_closest_bvh_full(packed, bounds, meta, o.contiguous(),
                                      d, 0.0, tmax)
    assert torch.equal(got, want)
    assert (got[:W * H, 1] >= 0).float().mean() > 0.05
