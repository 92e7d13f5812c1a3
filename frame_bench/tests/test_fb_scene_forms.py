"""The two scene forms and the camera paths: the plate's arrays reach the
program as before, the orbit path cycles and chains its matrices, and
the reference's pieces for a glTF scene (its cluster check, instances,
textures, froxel lists, moving-camera culling) agree with the program
on the CPU."""

import json

import numpy as np
import pytest
import torch

from fb_helpers import ROOT  # noqa: F401  (puts the repository on sys.path)

from frame_bench.harness import program
from frame_bench.inputs import camera, gltf_plates, plate
from frame_bench.ref import deferred, shade, trace

SMALL = dict(n_clusters=24, n_instanced=8, scatter_lights=40, light_range=0.3,
             layout_seed=0, texture_sizes=(32, 16, 16))


def frozen_build_scene(inputs: dict, bvh: bool, device) -> dict:
    """build_scene as it stood before it took the glTF form (the plate's
    arrays alone, a constant 128 triangles a cluster)."""
    from prosper_tpu_torch.accel.bvh import build_bvh, pack_nodes
    from prosper_tpu_torch.scene.convert import from_numpy_scene
    from prosper_tpu_torch.scene.lights import LightArrays, light_uniforms

    p0, p1, p2 = inputs["p0"], inputs["p1"], inputs["p2"]
    C = p0.shape[0] // 128
    corners = np.stack([p0, p1, p2], 1).reshape(C, 128 * 3, 3)
    wc_min, wc_max = corners.min(1), corners.max(1)
    center = (wc_min + wc_max) / 2
    nv = inputs["a_packed"].shape[0] // C
    static = {
        "wc_instance": np.zeros(C, np.int32),
        "wc_material": inputs["cluster_material"],
        "wc_sphere_center": center.astype(np.float32),
        "wc_sphere_radius": np.linalg.norm(wc_max - center, axis=1).astype(np.float32),
        "wc_cone_axis": inputs["a_packed"][::nv, 0:3].copy(),
        "wc_cone_cutoff": np.ones(C, np.float32),
        "wc_tri_count": np.full(C, 128, np.int32),
        "wt_p0": p0, "wt_p1": p1, "wt_p2": p2,
        "wt_aidx": inputs["aidx"],
        "wt_instance": np.zeros(p0.shape[0], np.int32),
        "wt_material": inputs["tri_material"],
        "a_packed": inputs["a_packed"],
        "materials": inputs["materials"],
    }
    lights = LightArrays()
    lights.dir_irradiance = inputs["sun_irradiance"]
    lights.dir_direction = inputs["sun_direction"]
    n = inputs["point_position"].shape[0]
    lights.point_position[:n] = inputs["point_position"]
    lights.point_radiance[:n] = inputs["point_radiance"]
    lights.point_radius[:n] = inputs["point_radius"]
    lights.point_count = n
    frame = {
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "transforms": np.eye(4, dtype=np.float32)[None, :3, :4],
        "normal_transforms": np.eye(3, dtype=np.float32)[None],
        "lights": light_uniforms(lights),
    }
    if bvh:
        frame["bvh_bounds"], frame["bvh_meta"] = pack_nodes(
            build_bvh(wc_min, wc_max, max_leaf_size=1))
    arena = {
        "data": np.full((1, 4), 0xFFFFFFFF, np.uint32),
        "table": np.zeros((1, 13, 4), np.int32)
        + np.array([0, 1, 1, 0], np.int32)[None, None, :],
        "n_mips": np.ones(1, np.int32),
    }
    return from_numpy_scene(static, frame, arena, device)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("bvh", [True, False])
def test_plate_scene_as_before(bvh):
    """The plate's arrays through build_scene give the tensors of the
    frozen build_scene, key by key."""
    inp = plate.make(dict(n_clusters=27, scatter_lights=40, layout_seed=0),
                     2**31 + 17)
    _assert_same(program.build_scene(inp, bvh, "cpu"),
                 frozen_build_scene(inp, bvh, "cpu"))


def test_static_path_unchanged():
    inp = plate.make_plate_inputs(8, 0, 4)
    got = camera.camera_path({"kind": "static"}, inp["eye"], inp["target"],
                             64, 48)
    want = camera.uniforms(inp["eye"], inp["target"], 64, 48)
    assert len(got) == 1
    for k in want:
        assert np.array_equal(np.asarray(got[0][k]), np.asarray(want[k])), k
    assert np.array_equal(got[0]["prev_world_to_clip"], want["world_to_clip"])


@pytest.mark.parametrize("deg", [10, 45, 7.5])
def test_orbit_path(deg):
    """360 / d positions at the eye's distance from the target and its
    height, position 0 the scene's eye, each prev_world_to_clip the
    previous position's, the cycle closed."""
    eye = np.float32([3.0, 2.0, 4.0])
    target = np.float32([0.5, 0.25, -1.0])
    cams = camera.camera_path({"kind": "orbit", "deg_per_frame": deg}, eye,
                              target, 64, 48)
    n = round(360 / deg)
    assert len(cams) == n
    assert np.array_equal(cams[0]["eye"], eye)
    dist = [np.linalg.norm(c["eye"] - target) for c in cams]
    np.testing.assert_allclose(dist, np.linalg.norm(eye - target), rtol=1e-6)
    np.testing.assert_allclose([c["eye"][1] for c in cams], eye[1], rtol=1e-6)
    for k, c in enumerate(cams):
        assert np.array_equal(c["prev_world_to_clip"],
                              cams[k - 1]["world_to_clip"])
        want = camera.uniforms(c["eye"], target, 64, 48)
        for key in want:
            if key != "prev_world_to_clip":
                assert np.array_equal(np.asarray(c[key]), np.asarray(want[key]))
    # the turn between neighbours is deg
    a, b = cams[0]["eye"] - target, cams[1]["eye"] - target
    ang = np.degrees(np.arccos(np.dot(a[[0, 2]], b[[0, 2]])
                               / np.dot(a[[0, 2]], a[[0, 2]])))
    assert abs(ang - deg) < 1e-3


@pytest.mark.parametrize("deg", [0, -10, 7, 200])
def test_orbit_refuses_a_step_that_does_not_divide_360(deg):
    with pytest.raises(ValueError):
        camera.camera_path({"kind": "orbit", "deg_per_frame": deg},
                           np.ones(3), np.zeros(3), 8, 8)


@pytest.fixture
def small_scene():
    inp = gltf_plates.make_inputs(**SMALL, seed=5)
    scene = program.build_scene(inp, True, "cpu")
    yield inp, scene
    import shutil
    shutil.rmtree(inp["scene_dir"], ignore_errors=True)


def test_cluster_check(small_scene):
    """The program's clusters of plates of 7x7 quads pass (64 vertices,
    98 triangles a plate); a triangle named twice, a triangle left out,
    a slot in the wrong instance, a cluster of more than 124 triangles
    and one of more than 64 vertices do not."""
    inp, scene = small_scene
    cl = program.clusters(scene)
    insts = trace.instances(inp["nodes"], inp["roots"])
    _, slot_tri, most = trace.check_clusters(inp["meshes"], insts, cl)
    assert (slot_tri >= 0).sum() == sum(
        len(inp["meshes"][m]["indices"]) for m, _ in insts)
    assert most == 64

    def broken(edit):
        bad = {k: v.copy() for k, v in cl.items()}
        edit(bad)
        with pytest.raises(trace.ClusterError):
            trace.check_clusters(inp["meshes"], insts, bad)

    def twice(c):
        c["wt_aidx"][1] = c["wt_aidx"][0]

    def left_out(c):
        c["wc_tri_count"][0] -= 1

    def other_instance(c):
        c["wc_instance"][-1] = c["wc_instance"][-3]

    def too_many(c):
        c["wc_tri_count"][0] = 125

    def rotated(c):
        c["wt_aidx"][0] = c["wt_aidx"][0][[1, 2, 0]]

    def merged(c):
        """Cluster 0 filled to 124 triangles from cluster 1 (two plates
        of 98 triangles and 64 vertices each): within upstream's
        triangle limit, over its vertex one."""
        a = c["wt_aidx"].reshape(-1, 128, 3)
        n = c["wc_tri_count"]
        moved = a[1, :124 - n[0]].copy()
        a[1, :n[1] - len(moved)] = a[1, len(moved):n[1]]
        a[0, n[0]:124] = moved
        n[1] -= len(moved)
        n[0] = 124

    for edit in (twice, left_out, other_instance, too_many, rotated, merged):
        broken(edit)
    # the merged partition is refused for its vertices alone
    bad = {k: v.copy() for k, v in cl.items()}
    merged(bad)
    with pytest.raises(trace.ClusterError, match="64 vertices"):
        trace.check_clusters(inp["meshes"], insts, bad)


def test_plates_of_81_vertices_are_refused(monkeypatch):
    """World cuts a plate of 8x8 quads (81 vertices, 128 triangles) into
    clusters of 124 and 4 triangles; the first holds more vertices than
    upstream's meshlets, so the partition is refused."""
    monkeypatch.setattr(gltf_plates, "PLATE_QUADS", 8)
    inp = gltf_plates.make_inputs(**SMALL, seed=5)
    try:
        scene = program.build_scene(inp, False, "cpu")
    finally:
        import shutil
        shutil.rmtree(inp["scene_dir"], ignore_errors=True)
    with pytest.raises(trace.ClusterError, match="more than 64 vertices"):
        trace.scene_slots(inp, program.clusters(scene))


def test_instances_place_the_triangles(small_scene):
    """The reference's world-space triangles, from the nodes' TRS (a
    reflected one among them), equal the program's slabs."""
    inp, scene = small_scene
    assert any(nd["scale"][0] < 0 for nd in inp["nodes"])
    slots = trace.scene_slots(inp, program.clusters(scene))
    slab = scene["geom"]["packed_full"].numpy()
    real = (np.arange(128)[None] < slots["count"][:, None]).reshape(-1)
    for row, key in ((0, "p0"),):
        got = slab[:, row:row + 3, :].transpose(0, 2, 1).reshape(-1, 3)
        np.testing.assert_allclose(got[real], slots[key][real], atol=2e-6)
    e1 = slab[:, 3:6, :].transpose(0, 2, 1).reshape(-1, 3)
    np.testing.assert_allclose(e1[real], (slots["p1"] - slots["p0"])[real],
                               atol=4e-6)
    # world normals: the slab's corner-0 normal, by the inverse transpose
    n0 = slab[:, 9:12, :].transpose(0, 2, 1).reshape(-1, 3)[real]
    ref = slots["corner_normal"][real, 0]
    ref = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    np.testing.assert_allclose(n0, ref, atol=2e-6)
    t0 = slab[:, 18:22, :].transpose(0, 2, 1).reshape(-1, 4)[real]
    rt = slots["corner_tangent"][real, 0]
    rt3 = rt[:, :3] / np.linalg.norm(rt[:, :3], axis=1, keepdims=True)
    np.testing.assert_allclose(t0[:, :3], rt3, atol=2e-6)
    assert np.array_equal(t0[:, 3], rt[:, 3])
    np.testing.assert_allclose(slab[:, 37, :].reshape(-1)[real],
                               slots["tri_lod"][real], atol=1e-5)


def test_texture_taps_equal_the_programs():
    """The reference's mips and trilinear taps (sRGB and linear, REPEAT,
    lods below, inside and past the chain) equal the program's sampling
    of its texture arena."""
    from prosper_tpu_torch.ops.texture import sample_trilinear
    from prosper_tpu_torch.scene.textures import generate_mips, pack_rgba8_quads

    rng = np.random.default_rng(4)
    for srgb, (h, w) in ((True, (32, 32)), (False, (16, 64))):
        px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        mips = generate_mips(px, srgb)
        ref = shade.Texture({"pixels": px, "srgb": srgb}, "cpu")
        assert len(ref.mips) == len(mips)
        for m, mip in enumerate(mips):
            want = torch.as_tensor(mip).float() / 255.0
            if srgb:
                want = torch.cat([shade.srgb_to_linear(want[..., :3]),
                                  want[..., 3:]], -1)
            assert torch.equal(ref.mips[m], want), m
        table = np.zeros((1, 13, 4), np.int32)
        off, chunks = 0, []
        for m, mip in enumerate(mips):
            table[0, m] = (off, mip.shape[1], mip.shape[0], int(srgb))
            chunks.append(pack_rgba8_quads(mip))
            off += mip.shape[0] * mip.shape[1]
        table[0, len(mips):] = table[0, len(mips) - 1]
        arena = {"data": torch.as_tensor(np.concatenate(chunks).astype(np.int64)),
                 "table": torch.as_tensor(table),
                 "n_mips": torch.tensor([len(mips)], dtype=torch.int32)}
        R = 4000
        uv = torch.as_tensor(rng.uniform(-3, 3, (R, 2)), dtype=torch.float32)
        lod = torch.as_tensor(rng.uniform(-12, 4, R), dtype=torch.float32)
        size = torch.tensor(float(max(h, w)))
        got = sample_trilinear(arena, torch.zeros(R, dtype=torch.int64), uv,
                               lod + torch.log2(size))
        np.testing.assert_allclose(ref.sample(uv, lod).numpy(), got.numpy(),
                                   rtol=0, atol=2e-7)
        np.testing.assert_allclose(ref.sample(uv).numpy(), sample_trilinear(
            arena, torch.zeros(R, dtype=torch.int64), uv,
            torch.zeros(R)).numpy(), rtol=0, atol=2e-7)


def _gbuffer(seed, n_lights, radius, width=64, height=64):
    """A G-buffer and its shading surface from the program, on the plate
    scene with point lights of the given radius."""
    from prosper_tpu_torch.render.gbuffer import render_gbuffer
    from prosper_tpu_torch.scene.convert import camera_tensors

    inp = plate.make(dict(n_clusters=27, scatter_lights=n_lights,
                          layout_seed=0), seed)
    inp["point_radius"] = np.full_like(inp["point_radius"], radius)
    scene = program.build_scene(inp, True, "cpu")
    cam_np = camera.uniforms(inp["eye"], inp["target"], width, height)
    cam = camera_tensors(cam_np, "cpu")
    return inp, scene, cam, render_gbuffer(scene, cam, width, height)


@pytest.mark.parametrize("n_lights,radius", [(40, 1.5), (300, 3.0), (300, 100.0)])
def test_froxel_lists_shade_as_the_program(n_lights, radius):
    """The reference's froxel lists shade the program's G-buffer as the
    program's clustered shading does: lights of finite range, also where
    a froxel lists more than 128, and lights that reach every surface."""
    from prosper_tpu_torch.ops.shade_tiles import build_tile_light_lists
    from prosper_tpu_torch.render.shading import shade_direct

    W = H = 64
    inp, scene, cam, gb = _gbuffer(7, n_lights, radius, W, H)
    lights = scene["frame"]["lights"]
    lists, counts, _ = build_tile_light_lists(cam, lights, W, H)
    if radius == 3.0:
        assert int(counts.max()) > 128  # the cap is reached
    want = shade_direct(gb["surface"], lights, cam, gb["z_cam"], gb["valid"],
                        W, H)
    sd = shade.SceneData(inp, trace.scene_slots(inp), "cpu")
    surf = gb["surface"]
    s = {"normal": surf["normal_ws"], "view": surf["inv_view_ray"],
         "albedo": surf["albedo"], "roughness": surf["roughness"],
         "metallic": surf["metallic"]}
    px = torch.arange(W).repeat(H)
    py = torch.arange(H).repeat_interleave(W)
    pos = gb["position_ws"]
    got = shade.brdf_nol(sd.sun_l.expand_as(s["normal"]), s) * sd.sun_irradiance
    got = deferred.point_lights(sd, s, pos, gb["valid"], {
        k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
        camera.uniforms(inp["eye"], inp["target"], W, H).items()},
        W, H, px, py, got)
    got = torch.where(gb["valid"][:, None], got, 0.0)
    err = (got - want).abs() / (want.abs() + 1e-3)
    assert float(err.max()) < 1e-4

def test_moving_camera_culling_counts_as_the_program(small_scene):
    """Under an orbit, frame by frame, the reference's two phases on the
    program's previous pyramid draw as many clusters as the program, and
    the pyramid it makes equals the program's next one; the reference's
    own chain from the first frame (`deferred.pyramid` for each frame
    before) draws as many too."""
    from prosper_tpu_torch.render.deferred import deferred_entry
    from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
    from prosper_tpu_torch.scene.convert import camera_tensors

    inp, scene = small_scene
    W = H = 48
    cams = camera.camera_path({"kind": "orbit", "deg_per_frame": 30},
                              inp["eye"], inp["target"], W, H)
    slots = trace.scene_slots(inp, program.clusters(scene))
    tris = trace.Triangles.from_slots(slots, "cpu")
    lut = torch.as_tensor(pack_lut_quads(synthetic_lut()))
    state, drawn, own = None, [], None
    sd = shade.SceneData(inp, slots, "cpu")
    from frame_bench.ref.restir import pixels, primary_rays
    for i in range(8):
        cam_np = cams[i % len(cams)]
        prev = None if state is None else state["hiz"]
        _, state = deferred_entry(scene=scene, cam=camera_tensors(cam_np, "cpu"),
                                  lut=lut, width=W, height=H, device="cpu",
                                  state=state, use_culling=True)
        cam = {k: torch.as_tensor(np.asarray(v, np.float32))
               for k, v in cam_np.items()}
        px, py = pixels(W, H, "cpu")
        o, d = primary_rays(cam, W, H, px, py)
        _, count, fresh = deferred.culled_trace(tris, cam, o, d, W, H, i, prev)
        assert count == int(state["draw_stats"]["drawn_meshlets"]), i
        diff = (fresh[0] - state["hiz"][0]).abs() > 1e-4 * fresh[0].abs()
        assert float(diff.float().mean()) < 0.01, i
        assert deferred.culled_trace(tris, cam, o, d, W, H, i, own)[1] == count
        own = deferred.pyramid(tris, sd, cam, W, H, i, own)
        assert all(torch.equal(a, b) for a, b in zip(own, fresh)), i
        drawn.append(count)
    assert len(set(drawn)) > 1  # the view changes what is drawn
    assert min(drawn) < tris.v0.shape[0]  # and culling holds some back


def test_gltf_form_file_is_the_arrays(small_scene):
    """The written file holds the arrays the generator returns."""
    inp, _ = small_scene
    doc = json.loads(open(inp["gltf"]).read())
    assert len(doc["nodes"]) == len(inp["nodes"]) + len(inp["point_position"])
    lights = doc["extensions"]["KHR_lights_punctual"]["lights"]
    np.testing.assert_array_equal(
        np.float32([l["range"] for l in lights]), inp["point_radius"])
    for m in inp["meshes"]:
        assert np.array_equal(m["positions"], gltf_plates.f16(m["positions"]))
        assert np.array_equal(m["uv"], gltf_plates.f16(m["uv"]))


def test_display_transform_takes_a_colour_that_is_not_finite():
    """A NaN or infinite colour (as a bfloat16 control may make) is shown
    as some value, and the comparison counts it off, without an index
    out of range."""
    lut = torch.as_tensor(shade.display_lut())
    c = torch.tensor([[0.5, 0.2, 0.1], [float("nan"), 0.1, 0.2],
                      [float("inf"), 1.0, 0.0]])
    for dt in (torch.float32, torch.bfloat16):
        out = shade.tone_map(c, lut, dt)
        assert out.shape == (3, 3)
        assert torch.isfinite(out[0]).all()


def test_reference_colour_that_is_not_finite_is_off():
    """A pixel where the reference's own colour is not finite counts as
    off in both comparisons, whatever the program shows there."""
    from frame_bench.compare import accumulate, frame

    lut = torch.as_tensor(shade.display_lut())
    ref = torch.full((2, 2, 3), 0.25)
    ref[0, 1, 0] = float("nan")
    ref[1, 0, 2] = float("inf")
    chk = {"display_atol": 1e-4, "pixel_atol": 1e-4, "pixel_rtol": 1e-4}
    shown = shade.tone_map(torch.full((2, 2, 3), 0.25), lut)
    port = {"image": shown, "stat": 5}
    assert frame.numbers(port, ref, 5, lut, chk)["pixels_off"] == 0.5
    assert frame.numbers(port, torch.full((2, 2, 3), 0.25), 5, lut,
                         chk)["pixels_off"] == 0.0
    acc = torch.full((2, 2, 3), 0.25)
    port = {"prev": None, "acc": acc, "count": torch.ones(2, 2),
            "image": shown, "stat": 5, "index": 0}
    got = accumulate.numbers(port, ref, 5, lut, chk)
    assert got["pixels_off"] == 0.5 and got["display_off"] == 0.0
    acc = acc.clone()
    acc[1, 1, 1] = float("nan")
    got = accumulate.numbers(dict(port, acc=acc), acc, 5, lut, chk)
    assert got["display_off"] == 0.25
