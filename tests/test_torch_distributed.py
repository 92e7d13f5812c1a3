"""Sharded frames of prosper_tpu_torch (render/distributed.py) on the CPU,
in gloo ranks, against the port's single-rank frames, JAX's sharded
calls on its virtual CPU mesh (tests/conftest.py) and JAX's
single-device frames; and the band parameters of the passes they call,
in process.

The ranks are spawned processes (render/distributed.run_ranks) running
the port's frame_worker, so they import neither JAX nor this module;
each builds the scene from the same seed. Every rank returns the
gathered frame, and all must be equal.

Tolerances:
- against the port's single-rank frame: integer outputs (ray counts,
  shadow rays) equal, colour within atol 1e-5 (PT rtol 1e-5 / atol
  1e-6, as tests/test_distributed.py holds JAX's); band rows of the
  G-buffer, the tile lists and spatial reuse equal the full frame's
  rows exactly;
- against JAX (its sharded call, its single-device frame): the rules
  of tests/test_torch_pt.py, test_torch_restir.py and
  test_torch_deferred.py for each mode, at most 0.5% of the pixels off
  by more than 1e-3 + 1e-3 relative, the PT ray counts equal; the
  passes' band outputs as test_torch_deferred.py and
  test_torch_restir.py hold the full frame's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import shade_tiles as jshade_tiles
from prosper_tpu.ops.clustering import build_light_clusters
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render import distributed as jdist
from prosper_tpu.render import restir as jrestir
from prosper_tpu.render.deferred import shade_deferred as j_shade_deferred
from prosper_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from prosper_tpu.render.pt import pt_render_sample as j_pt_render_sample
from prosper_tpu.scene.textures import build_texture_arena as j_arena
from prosper_tpu.scene.world import World as JWorld
from prosper_tpu_torch import testing
from prosper_tpu_torch.entry import gltf_scene
from prosper_tpu_torch.ops import shade_tiles
from prosper_tpu_torch.render import distributed, pt, restir
from prosper_tpu_torch.render.deferred import shade_deferred
from prosper_tpu_torch.render.gbuffer import render_gbuffer
from prosper_tpu_torch.scene.convert import (
    HOST_ONLY,
    camera_tensors,
    from_numpy_scene,
)

BOXES = (testing.make_test_scene, (4,), {})
PLATES = (testing.make_plate_scene, (64, 0), {"scatter_lights": 16})
GBUFFER_KEYS = ("albedo_roughness", "normal_metallic", "velocity", "depth",
                "z_cam", "position_ws", "valid")


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items() if k not in HOST_ONLY}


def _scenes(make, width, height):
    """(JAX static, frame, arena, camera; port scene, camera) of one
    numpy scene."""
    fn, args, kwargs = make
    static, frame, arena, cam_fn = fn(*args, **kwargs)
    cam = cam_fn(width, height)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    return ((js, jf, ja, _jdev(cam)),
            (from_numpy_scene(static, frame, arena, "cpu"),
             camera_tensors(cam, "cpu")))


def _off_share(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1).mean()


def _ranks(make, width, height, n, mode, options):
    """The sharded frame of every rank -> its (colour, stat), checked
    equal over the ranks."""
    job = {"scene": make, "width": width, "height": height,
           "calls": [(mode, options)]}
    outs = [o[0] for o in distributed.run_ranks(
        distributed.frame_worker, n, job, backend="gloo",
        devices=["cpu"] * n)]
    for color, stat in outs[1:]:
        np.testing.assert_array_equal(color, outs[0][0])
        assert stat == outs[0][1]
    return outs[0]


def _port_single(mode, scene, cam, width, height, options):
    if mode == "pt":
        c, n = pt.pt_render_sample(scene, cam, width, height,
                                   options["frame_index"],
                                   options["max_bounces"], return_stats=True,
                                   device="cpu")
        return c.numpy(), int(n)
    if mode == "restir":
        c, n = restir.render_restir(scene, cam, width, height,
                                    options["frame_index"])
        return c.numpy(), int(n)
    gbuf = render_gbuffer(scene, cam, width, height)
    return shade_deferred(gbuf, scene["frame"]["lights"], cam, width,
                          height).numpy(), None


def _jax_frames(mode, jscene, width, height, n, options):
    """(JAX's sharded colour on make_mesh(n), its ray count or None; its
    single-device colour, its ray count or None)."""
    js, jf, ja, jcam = jscene
    mesh = jdist.make_mesh(n)
    if mode == "pt":
        args = (js, jf, ja, jcam, width, height, options["frame_index"])
        color, rays = jdist.pt_render_sharded(
            mesh, *args, max_bounces=options["max_bounces"])
        single, single_rays = j_pt_render_sample(
            *args, max_bounces=options["max_bounces"], return_stats=True)
        return (np.asarray(color), int(rays)), (np.asarray(single),
                                                int(single_rays))
    if mode == "restir":
        color = jdist.restir_render_sharded(
            mesh, js, jf, ja, jcam, width, height, options["frame_index"])
        lut = jnp.zeros((48, 48, 48, 3), jnp.float32)
        _, single = jrestir.render_restir(js, jf, ja, jcam, lut, width,
                                          height, options["frame_index"])
        return (np.asarray(color), None), (np.asarray(single), None)
    color = jdist.deferred_render_sharded(mesh, js, jf, ja, jcam, width,
                                          height)
    gbuf = j_render_gbuffer(js, jf, ja, jcam, width, height)
    clusters = build_light_clusters(jcam, jf["lights"], width, height)
    single = j_shade_deferred(gbuf, clusters, jf["lights"], jcam, width,
                              height)
    return (np.asarray(color), None), (np.asarray(single), None)


# id -> (mode, scene, width, height, ranks, options): JAX's five cases
# (tests/test_distributed.py) at small sizes
CASES = {
    "pt-64x32-4": ("pt", BOXES, 64, 32, 4,
                   {"frame_index": 0, "max_bounces": 2}),
    # 16-row bands: the 90 rows above a band come from up to three ranks
    # away, and the first and last bands take zeros past the frame
    "restir-64x64-4": ("restir", PLATES, 64, 64, 4, {"frame_index": 5}),
    # 19-row bands; the last band's rows 76-79 lie past the frame
    "restir-64x76-4": ("restir", PLATES, 64, 76, 4, {"frame_index": 5}),
    "deferred-64x64-2": ("deferred", PLATES, 64, 64, 2, {}),
    # 64-row bands: the second holds 8 rows of the frame
    "deferred-64x72-2": ("deferred", PLATES, 64, 72, 2, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_frame_matches_single_and_jax(case):
    mode, make, width, height, n, options = CASES[case]
    color, stat = _ranks(make, width, height, n, mode, options)
    jscene, (scene, cam) = _scenes(make, width, height)
    want, want_stat = _port_single(mode, scene, cam, width, height, options)
    assert color.shape == want.shape == (width * height, 3)
    assert stat == want_stat
    if mode == "pt":
        np.testing.assert_allclose(color, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(color, want, rtol=0, atol=1e-5)
    assert (want.sum(-1) > 0).mean() > 0.01
    if mode == "restir":
        assert stat > 0.01 * width * height
    (j_sharded, j_rays), (j_single, j_single_rays) = _jax_frames(
        mode, jscene, width, height, n, options)
    assert _off_share(color, j_sharded) <= 5e-3
    assert _off_share(color, j_single) <= 5e-3
    if mode == "pt":
        assert stat == j_rays == j_single_rays


def test_gbuffer_band_rows_equal_full_frame():
    """A band of render_gbuffer (y_offset, full_height) equals the full
    frame's rows, with BVH arrays (K1's band form) and without (K8);
    against JAX's band; culling on a band raises."""
    width, height, y0, band_h = 64, 64, 24, 20
    jscene, (scene, cam) = _scenes(PLATES, width, height)
    band = {"y_offset": y0, "full_height": height}
    rows = slice(y0 * width, (y0 + band_h) * width)
    for bvh in (True, False):
        sc = scene if bvh else {**scene, "frame": {
            k: v for k, v in scene["frame"].items()
            if k not in ("bvh_bounds", "bvh_meta")}}
        full = render_gbuffer(sc, cam, width, height)
        got = render_gbuffer(sc, cam, width, band_h, **band)
        for k in GBUFFER_KEYS:
            assert torch.equal(got[k], full[k][rows]), (bvh, k)
        assert 0.05 < float(got["valid"].float().mean()) < 0.95
    js, jf, ja, jcam = jscene
    want = j_render_gbuffer(js, jf, ja, jcam, width, band_h, **band)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k, rtol, atol in (("albedo_roughness", 0, 1e-5),
                          ("normal_metallic", 0, 1e-5), ("depth", 0, 1e-5),
                          ("z_cam", 1e-4, 1e-5),
                          ("position_ws", 1e-4, 1e-4)):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=rtol,
                                   atol=atol, err_msg=k)
    with pytest.raises(ValueError, match="per band"):
        render_gbuffer(scene, cam, width, band_h, use_culling=True, **band)


def test_tile_light_lists_band_rows_equal_full_frame():
    """build_tile_light_lists on a band at a tile row equals the full
    frame's rows of tiles (lists, counts, light z) and JAX's band lists;
    a band off the 32 px tile raises. The plate scene's lights with a
    tenth of their radius, so that the tiles' lists differ."""
    width, height = 96, 128

    def small_lights():
        static, frame, arena, cam_fn = testing.make_plate_scene(
            64, 0, scatter_lights=16)
        frame["lights"]["point_radius"] *= 0.1
        return static, frame, arena, cam_fn

    jscene, (scene, cam) = _scenes((small_lights, (), {}), width, height)
    lights = scene["frame"]["lights"]
    full = shade_tiles.build_tile_light_lists(cam, lights, width, height)
    fx, _ = shade_tiles.tile_grid(width, height)
    js, jf, ja, jcam = jscene
    for y0, band_h in ((32, 64), (96, 32), (0, 32)):
        got = shade_tiles.build_tile_light_lists(
            cam, lights, width, band_h, y_offset=y0, full_height=height)
        tiles = slice(y0 // 32 * fx, (y0 + band_h) // 32 * fx)
        assert torch.equal(got[0], full[0][tiles])
        assert torch.equal(got[1], full[1][tiles])
        assert torch.equal(got[2], full[2])
        want = jshade_tiles.build_tile_light_lists(
            jcam, jf["lights"], width, band_h, y_offset=y0,
            full_height=height)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for t in range(got[0].shape[0]):  # the visible prefix, in order
            c = int(got[1][t])
            np.testing.assert_array_equal(got[0][t, :c].numpy(),
                                          np.asarray(want[0])[t, :c])
    assert len(set(full[1].tolist())) > 2
    with pytest.raises(ValueError, match="multiple of 32"):
        shade_tiles.build_tile_light_lists(cam, lights, width, 32,
                                           y_offset=16, full_height=height)


def test_spatial_reuse_band_and_halo_equals_full_frame():
    """spatial_reuse of a band over its rows and halo (neigh_y0,
    neigh_rows_h; zero rows past the frame's top) equals the full
    frame's rows of the full-frame reuse, exactly; JAX's band call as
    test_torch_restir.py holds JAX's full frame (indices equal on 99.9%
    of the pixels, UCW rtol 1e-4 where they agree)."""
    width = height = 64
    jscene, (scene, cam) = _scenes(PLATES, width, height)
    gbuf = render_gbuffer(scene, cam, width, height)
    surface = dict(gbuf["surface"])
    c2c = cam["camera_to_clip"]
    lin = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
    surface["linear_depth"] = lin
    lights = scene["frame"]["lights"]
    px = torch.arange(width).repeat(height)
    py = torch.arange(height).repeat_interleave(width)
    li0, ucw0 = restir.initial_reservoirs(surface, lights, px, py, 3)
    li0 = torch.where(gbuf["valid"], li0, -1)
    rows = restir.pack_neighbor_rows(
        {"linear_depth": lin, "normal_metallic": gbuf["normal_metallic"]},
        li0, ucw0)
    full = restir.spatial_reuse(surface, lights, rows, px, py, width, height,
                                3)
    up, dn = distributed.HALO_UP, distributed.HALO_DN
    padded = torch.cat([rows.new_zeros((up * width, 8)), rows,
                        rows.new_zeros((dn * width, 8))])
    js, jf, ja, jcam = jscene
    for y0, band_h in ((40, 16), (0, 24), (48, 16)):
        sel = slice(y0 * width, (y0 + band_h) * width)
        band_s = {k: v[sel] if isinstance(v, torch.Tensor) and v.dim()
                  and v.shape[0] == width * height else v
                  for k, v in surface.items()}
        neigh = padded[y0 * width:(y0 + band_h + up + dn) * width]
        args = (neigh, px[sel], py[sel], width, height, 3)
        band = {"neigh_y0": y0 - up, "neigh_rows_h": band_h + up + dn}
        got = restir.spatial_reuse(band_s, lights, *args, **band)
        assert torch.equal(got[0], full[0][sel]) and torch.equal(
            got[1], full[1][sel])
        want = jrestir.spatial_reuse(
            {k: jnp.asarray(v.numpy()) for k, v in band_s.items()
             if isinstance(v, torch.Tensor)}, jf["lights"],
            jnp.asarray(neigh.numpy()), jnp.asarray(px[sel].numpy(),
                                                    jnp.uint32),
            jnp.asarray(py[sel].numpy(), jnp.uint32), width, height, 3,
            **band)
        same = got[0].numpy() == np.asarray(want[0])
        assert same.mean() >= 0.999
        np.testing.assert_allclose(got[1].numpy()[same],
                                   np.asarray(want[1])[same], rtol=1e-4)
    assert int((full[0] >= 0).sum()) > 0.05 * width * height


@pytest.fixture(scope="module")
def plates_gltf(tmp_path_factory):
    return testing.write_plate_gltf(tmp_path_factory.mktemp("plates"), 64,
                                    n_instanced=8, scatter_lights=16)


def test_textured_bands_keep_the_full_frame_cone(plates_gltf):
    """On the textured plate scene (multi-mip arena) the port's sharded
    deferred frame equals its single-rank frame: its band G-buffers take
    the ray-cone spread of the full frame's height. JAX's bands take
    their own height (prosper_tpu/render/gbuffer.py:372), so a band
    samples coarser mips and JAX's sharded frame differs from its
    single-device frame."""
    width, height, n = 64, 64, 2
    make = (gltf_scene, (plates_gltf,), {"use_cache": False})
    color, _ = _ranks(make, width, height, n, "deferred", {})
    static, frame, arena, cam_fn = gltf_scene(plates_gltf, use_cache=False)
    assert int(np.asarray(arena["n_mips"]).max()) > 1
    scene = from_numpy_scene(static, frame, arena, "cpu")
    cam = camera_tensors(cam_fn(width, height), "cpu")
    want, _ = _port_single("deferred", scene, cam, width, height, {})
    np.testing.assert_allclose(color, want, rtol=0, atol=1e-5)

    jw = JWorld(plates_gltf, use_cache=False)
    js = _jdev(jw.static_scene_arrays())
    jf = _jdev(jw.frame_arrays(0.0))
    ja = _jdev(j_arena(jw.doc, max_dim=2048).uniforms())
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    jcam = _jdev(jw.make_camera((width, height)).uniforms())
    (j_sharded, _), (j_single, _) = _jax_frames(
        "deferred", (js, jf, ja, jcam), width, height, n, {})
    assert _off_share(want, j_single) <= 5e-3  # the port: JAX's one device
    jdiff = np.abs(j_sharded - j_single).max(-1)
    assert (jdiff > 1e-3).mean() > 0.05, (jdiff > 1e-3).mean()
