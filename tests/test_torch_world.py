"""The glTF scene path of prosper_tpu_torch against prosper_tpu on the
CPU: scene/world.py `World` (glTF loading, scene graph, animation, native
mesh processing, meshlets, quantization, caches, lights), the texture
arena with mips, the camera, the trilinear, anisotropic and fixed-mip
material taps, and 64x64 forward, deferred and path-traced frames of a
textured glTF scene.

The tests write their own glTF files: the quad of tests/test_cli.py
`_write_tiny_gltf` (a data-URI buffer, POSITION only), and a feature
scene written as .gltf (PNG files) and as .glb (PNGs in the buffer):
nested TRS nodes, one mesh instanced twice, a primitive without a
material, rotation (LINEAR) and translation (STEP) animation channels,
directional, point and spot lights, a camera, sRGB and linear images of
several sizes and wrap modes, MASK and BLEND materials, and a mesh
without normals and tangents. Each package loads its own copy of a
scene, so their mesh and texture caches stay apart.

Tolerances:
- World arrays, the texture arena and the camera uniforms: exact (the
  same numpy code on the same file; the native library is built from the
  same source with the same flags);
- texture taps: rtol 1e-5 / atol 1e-6 (the same float32 operations);
- frames: at most 1% of the pixels (0.5% for the deferred frame, as
  tests/test_torch_deferred.py allows) off by more than 1e-3 + 1e-3
  relative. The JAX CPU frames trace with the XLA tracer and take the
  ray-cone LOD from gathered geometry; the port traces with the kernels'
  plain versions and takes it from the slabs' tri_lod, so a pixel at a
  triangle edge or a mip boundary may differ.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import texture as jtexture
from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render import surface as jsurface
from prosper_tpu.render.deferred import render_deferred as j_render_deferred
from prosper_tpu.render.forward import render_forward as j_render_forward
from prosper_tpu.render.pt import pt_render_sample as j_pt_render_sample
from prosper_tpu.scene.textures import build_texture_arena as j_arena
from prosper_tpu.scene.world import World as JWorld
from prosper_tpu_torch import testing
from prosper_tpu_torch.entry import entry, gltf_scene
from prosper_tpu_torch.mathx.transforms import look_at
from prosper_tpu_torch.ops import texture as ttexture
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import pt as tpt
from prosper_tpu_torch.render import surface as tsurface
from prosper_tpu_torch.render.deferred import deferred_entry
from prosper_tpu_torch.render.forward import forward_entry
from prosper_tpu_torch.scene import native
from prosper_tpu_torch.scene.convert import (
    HOST_ONLY,
    camera_tensors,
    from_numpy_scene,
)
from prosper_tpu_torch.scene.textures import build_texture_arena
from prosper_tpu_torch.scene.world import World
from tests.test_cli import _write_tiny_gltf

torch.set_num_threads(2)
W = H = 64
T_MID = 0.7  # inside both animation channels' key ranges
LUT = pack_lut_quads(synthetic_lut())


def _grid(n, size=1.0):
    """A flat (n+1)^2-vertex grid in the xz plane, 2 n^2 triangles."""
    u, v = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1),
                       indexing="ij")
    pos = np.stack([(u.ravel() - 0.5) * size, 0.1 * np.sin(3 * u.ravel()),
                    (v.ravel() - 0.5) * size], 1).astype(np.float32)
    uv = np.stack([u.ravel() * 2, v.ravel() * 2], 1).astype(np.float32)
    tris = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            tris += [(a, a + 1, a + n + 1), (a + 1, a + n + 2, a + n + 1)]
    return pos, uv, np.array(tris, np.uint32).reshape(-1)


def _box():
    """A unit cube of 24 vertices with normals and uvs (no tangents)."""
    pos, nrm, uv, idx = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            a, b = np.eye(3)[(axis + 1) % 3], np.eye(3)[(axis + 2) % 3]
            base = len(pos)
            for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                pos.append(0.5 * n + (du - 0.5) * a + (dv - 0.5) * b)
                nrm.append(n)
                uv.append((du, dv))
            quad = [0, 1, 2, 0, 2, 3] if sign > 0 else [0, 2, 1, 0, 3, 2]
            idx += [base + q for q in quad]
    return (np.float32(pos), np.float32(nrm), np.float32(uv),
            np.array(idx, np.uint16))


def _images():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (32, 64, 4)).astype(np.uint8)
    base[..., 3] = 255
    mr = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
    nrm = np.full((16, 16, 4), 255, np.uint8)
    nrm[..., :2] = rng.integers(100, 156, (16, 16, 2))
    y, x = np.mgrid[0:32, 0:32]
    alpha = np.full((32, 32, 4), 200, np.uint8)
    alpha[..., 3] = np.where((x // 4 + y // 4) % 2, 255, 0)
    glass = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    return [base, mr, nrm, alpha, glass]


def write_feature_scene(directory, glb=False) -> str:
    """The feature scene of the module docstring; returns its path."""
    bpos, bnrm, buv, bidx = _box()
    spos, suv, sidx = _grid(6, 2.0)
    gpos, guv, gidx = _grid(1, 1.5)
    gnrm = np.tile(np.float32([0, 1, 0]), (len(gpos), 1))
    gtan = np.tile(np.float32([1, 0, 0, -1]), (len(gpos), 1))
    q = testing.mat3_to_quat
    rot_y = q(np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]))
    tilt = q(np.array([[1.0, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]]))
    names = ["base.png", "mr.png", "normal.png", "alpha.png", "glass.png"]
    images = [{"pixels": p} if glb else {"uri": n, "pixels": p}
              for n, p in zip(names, _images())]
    cam_rot = q(look_at([0.5, 1.0, 4.5], [0.0, 0.0, 0.0],
                        [0.0, 1.0, 0.0])[:3, :3].T)
    doc = {
        "scene": 0,
        "scenes": [{"nodes": [0, 8]}],
        "nodes": [
            {"name": "root", "translation": [0.1, -0.2, 0.0],
             "rotation": tilt.tolist(), "scale": [1.1, 1.1, 1.1],
             "children": [1, 2, 4, 5, 6, 7]},
            {"name": "box a", "mesh": 0, "translation": [-1.0, 0.0, 0.0]},
            {"name": "group", "translation": [1.2, 0.3, -0.5],
             "rotation": rot_y.tolist(), "children": [3]},
            {"name": "box b", "mesh": 0, "scale": [0.5, 1.5, 0.8],
             "translation": [0.0, 0.5, 0.0]},
            {"name": "sheet", "mesh": 1, "translation": [0.0, -0.8, 0.0]},
            {"name": "glass", "mesh": 2, "translation": [0.0, 0.2, 1.0],
             "rotation": q(np.array([[1.0, 0, 0], [0, 0, -1],
                                     [0, 1, 0]])).tolist()},
            {"name": "sun", "rotation": tilt.tolist(),
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"name": "lamps", "translation": [0.0, 2.0, 0.0], "children": [9],
             "extensions": {"KHR_lights_punctual": {"light": 1}}},
            {"name": "camera", "camera": 0, "translation": [0.5, 1.0, 4.5],
             "rotation": cam_rot.tolist()},
            {"name": "spot", "translation": [1.0, 0.5, 2.0],
             "rotation": rot_y.tolist(),
             "extensions": {"KHR_lights_punctual": {"light": 2}}},
        ],
        "meshes": [
            {"name": "box", "primitives": [
                {"attributes": {"POSITION": bpos, "NORMAL": bnrm,
                                "TEXCOORD_0": buv},
                 "indices": bidx, "material": 0},
                {"attributes": {"POSITION": bpos[:12] * 1.2},
                 "indices": np.arange(12, dtype=np.uint32)}]},
            {"name": "sheet", "primitives": [
                {"attributes": {"POSITION": spos, "TEXCOORD_0": suv},
                 "indices": sidx, "material": 1}]},
            {"name": "glass", "primitives": [
                {"attributes": {"POSITION": gpos, "NORMAL": gnrm,
                                "TANGENT": gtan, "TEXCOORD_0": guv},
                 "indices": gidx, "material": 2}]},
        ],
        "materials": [
            {"name": "textured", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1},
                "metallicFactor": 0.5, "roughnessFactor": 0.9},
             "normalTexture": {"index": 2}},
            {"name": "mask", "alphaMode": "MASK", "alphaCutoff": 0.4,
             "pbrMetallicRoughness": {
                 "baseColorTexture": {"index": 3},
                 "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                 "metallicFactor": 0.0}},
            {"name": "blend", "alphaMode": "BLEND",
             "pbrMetallicRoughness": {
                 "baseColorTexture": {"index": 4},
                 "baseColorFactor": [0.3, 0.5, 0.9, 0.5],
                 "metallicFactor": 0.0, "roughnessFactor": 0.2}},
        ],
        "samplers": [{"wrapS": 10497, "wrapT": 33071},
                     {"wrapS": 33648, "wrapT": 10497}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1},
                     {"source": 2, "sampler": 1}, {"source": 3},
                     {"source": 4, "sampler": 1}],
        "images": images,
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.9, "znear": 0.05, "zfar": 50.0}}],
        "animations": [{
            "channels": [
                {"sampler": 0, "target": {"node": 4, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 3, "path": "translation"}},
            ],
            "samplers": [
                {"input": np.float32([0.0, 0.5, 1.5]),
                 "output": np.stack([q(np.eye(3)), rot_y, tilt]),
                 "interpolation": "LINEAR"},
                {"input": np.float32([0.0, 0.6, 1.0]),
                 "output": np.float32([[0, 0.5, 0], [0, 0.9, 0.2],
                                       [0.1, 0.2, 0.3]]),
                 "interpolation": "STEP"},
            ]}],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.9, 0.8],
             "intensity": 2.5},
            {"type": "point", "color": [1.0, 0.7, 0.5], "intensity": 60.0},
            {"type": "spot", "color": [0.5, 0.8, 1.0], "intensity": 80.0,
             "range": 9.0, "spot": {"innerConeAngle": 0.2,
                                    "outerConeAngle": 0.6}},
        ]}},
    }
    return testing.write_gltf(
        os.path.join(os.fspath(directory),
                     "features.glb" if glb else "features.gltf"), doc)


def _tiny(directory) -> str:
    from pathlib import Path

    path = Path(directory) / "quad.gltf"
    _write_tiny_gltf(path)
    return str(path)


WRITERS = {"quad": _tiny, "features": write_feature_scene,
           "features_glb": lambda d: write_feature_scene(d, glb=True)}


def _scene_pair(tmp_path, name):
    """The scene written twice, one copy per package."""
    paths = []
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        paths.append(WRITERS[name](d))
    return paths


def _assert_tree_equal(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
        elif k in HOST_ONLY:
            continue
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{where}/{k}")
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _compare_worlds(tw, jw, path_t, path_j, cache):
    _assert_tree_equal(tw.static_scene_arrays(), jw.static_scene_arrays(),
                       "static")
    for t in (0.0, T_MID):
        got, want = tw.frame_arrays(t), jw.frame_arrays(t)
        _assert_tree_equal(got, want, f"frame({t})")
        assert got["bvh_depth"] == want["bvh_depth"]
    _assert_tree_equal(
        build_texture_arena(tw.doc, scene_path=path_t if cache else None)
        .uniforms(),
        j_arena(jw.doc, scene_path=path_j if cache else None).uniforms(),
        "arena")
    _assert_tree_equal(tw.make_camera((W, 48)).uniforms(),
                       jw.make_camera((W, 48)).uniforms(), "camera")


@pytest.mark.parametrize("instance_grid", [1, 2])
@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("name", sorted(WRITERS))
def test_world_equals_jax(tmp_path, name, use_cache, instance_grid):
    """Every array of static_scene_arrays(), of frame_arrays(t) at t = 0
    and mid-animation, the texture arena and the camera uniforms: exact.
    With the cache, a second load (read from it) equals the first."""
    path_j, path_t = _scene_pair(tmp_path, name)
    assert native.available()
    jw = JWorld(path_j, use_cache=use_cache, instance_grid=instance_grid)
    tw = World(path_t, use_cache=use_cache, instance_grid=instance_grid)
    _compare_worlds(tw, jw, path_t, path_j, use_cache)
    if use_cache:
        assert os.listdir(os.path.join(os.path.dirname(path_t),
                                       "prosper_cache"))
        again = World(path_t, use_cache=True, instance_grid=instance_grid)
        _compare_worlds(again, jw, path_t, path_j, True)


def test_world_counts_its_meshlets_in_a_recording(tmp_path, caplog):
    """A World built in a recorded frame: a host span world.meshlets a
    primitive, and meshlet_counters of the scene it built (in its load
    log line): every cluster within upstream's limits."""
    import logging

    from prosper_tpu_torch.utils.profiler import gprofiler

    path = testing.write_plate_gltf(tmp_path, n_clusters=27, n_instanced=3,
                                    scatter_lights=8)
    with caplog.at_level(logging.INFO), gprofiler.recording():
        gprofiler.start_frame(0)
        world = World(path, use_cache=False)
        frame = gprofiler.end_frame()
    spans = [s for s in frame.spans if s.name == "world.meshlets"]
    assert len(spans) == len(world.meshes) == 2
    assert all(s.kind == "host" and s.end_ns > s.start_ns for s in spans)
    m = world.meshlet_counters
    assert m["tiles"] == world.n_world_clusters
    assert m["triangles"] == world.n_real_tris == 27 * 128
    assert m["meshlets"] == sum(len(x.clusters.cluster_count)
                                for x in world.meshes)
    assert 0 < m["max_vertices"] <= 64
    assert 0 < m["min_triangles"] <= m["mean_triangles"] <= 124
    assert m["mean_triangles"] == world.n_real_tris / world.n_world_clusters
    assert f"at most {m['max_vertices']} vertices" in caplog.text


def test_mesh_cache_of_an_older_version_is_not_read(tmp_path):
    """A version-4 file at a mesh's cache path (clusters by the old rule)
    is neither read nor trusted: the World regenerates, equal to one
    built without the cache."""
    from prosper_tpu_torch.scene import caches

    path = testing.write_plate_gltf(tmp_path, n_clusters=27, n_instanced=3,
                                    scatter_lights=8)
    assert caches.MESH_CACHE_VERSION == 5
    cpath = caches.mesh_cache_path(path, 0, 0)
    np.savez(cpath, __version__=4, cluster_count=np.full(3, 124, np.uint32))
    assert caches.load_mesh_cache(cpath) is None
    cached = World(path, use_cache=True)
    fresh = World(path, use_cache=False)
    _assert_tree_equal(cached.static_scene_arrays(),
                       fresh.static_scene_arrays(), "static")
    assert set(caches.load_mesh_cache(cpath)) >= {"cluster_count", "tri_vidx"}


def test_feature_scene_is_what_it_claims(tmp_path):
    """The feature scene exercises what the module docstring lists."""
    path = write_feature_scene(tmp_path)
    w = World(path, use_cache=False)
    assert len(w.doc.meshes) == 3 and len(w.graph.model_instance_nodes) == 4
    assert w.doc.meshes[1].primitives[0].normals is None
    assert w.doc.meshes[1].primitives[0].tangents is None
    assert set(w.materials.alpha_mode.tolist()) == {0, 1, 2}
    assert w.doc.image_color_spaces().count("srgb") == 3
    assert len(w.animation_channels) == 2
    la = w.lights
    assert la.point_count == 1 and la.spot_count == 1
    f0, f1 = w.frame_arrays(0.0), w.frame_arrays(T_MID)
    assert not np.array_equal(f0["transforms"], f1["transforms"])
    assert f0["scene_camera"] is not None
    a = build_texture_arena(w.doc).uniforms()
    assert (a["n_mips"] > 1).sum() >= 4


def test_world_refuses_streaming(tmp_path):
    """A streamed World shows no geometry before its worker delivers (the
    meshletCount == 0 gate), then the loaded World's arrays
    (tests/test_torch_streaming.py holds the streaming path against
    JAX's)."""
    path = _tiny(tmp_path)
    w = World(path, streaming=True, use_cache=False)
    assert (w.wc_tri_count == 0).all() and not w.wt_p0.any()
    w.start_streaming()
    deadline = time.monotonic() + 60
    while not w.streaming_done and time.monotonic() < deadline:
        w.poll_streaming()
        time.sleep(0.01)
    assert w.streaming_done and w.streaming_dirty
    _assert_tree_equal(w.static_scene_arrays(),
                       World(path, use_cache=False).static_scene_arrays())


def _jdev(tree):
    return {k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items() if k not in HOST_ONLY}


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """The feature scene through both packages: (JAX device dicts and
    camera, port scene and camera)."""
    d = tmp_path_factory.mktemp("textured")
    path_j, path_t = _scene_pair(d, "features")
    jw = JWorld(path_j, use_cache=False)
    js = _jdev(jw.static_scene_arrays())
    jf = _jdev(jw.frame_arrays(0.0))
    ja = _jdev(j_arena(jw.doc, max_dim=2048).uniforms())
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    jcam = _jdev(jw.make_camera((W, H)).uniforms())
    static, frame, arena, cam_fn = gltf_scene(path_t, use_cache=False)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    return (js, jf, ja, jcam), (scene, camera_tensors(cam_fn(W, H), "cpu"))


def _off_share(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1).mean()


@pytest.mark.parametrize("use_culling", [False, True])
def test_deferred_frame_matches_jax(textured, use_culling):
    """Trilinear taps at the ray-cone LOD, the transparent pass and two
    alpha-discard rounds (the CLI's flags for this scene)."""
    (js, jf, ja, jcam), (scene, tcam) = textured
    want, _ = j_render_deferred(js, jf, ja, jcam, jnp.asarray(LUT), W, H,
                                use_culling=use_culling,
                                use_transparent=True, alpha_rounds=2)
    got, state = deferred_entry(scene=scene, cam=tcam, lut=LUT, width=W,
                                height=H, device="cpu",
                                use_culling=use_culling,
                                use_transparent=True, alpha_rounds=2)
    assert _off_share(got.numpy(), want) <= 5e-3
    assert (state["depth"].numpy() > 0).mean() > 0.2


@pytest.mark.parametrize("aniso_taps", [1, 4])
def test_forward_frame_matches_jax(textured, aniso_taps):
    (js, jf, ja, jcam), (scene, tcam) = textured
    want = j_render_forward(js, jf, ja, jcam, jnp.asarray(LUT), W, H, 1.0,
                            1.0, 0, True, 2, aniso_taps=aniso_taps)
    got, state = forward_entry(scene=scene, cam=tcam, lut=LUT, width=W,
                               height=H, device="cpu", use_transparent=True,
                               alpha_rounds=2, aniso_taps=aniso_taps)
    assert _off_share(got.numpy(), want) <= 1e-2
    assert 0 < int(state["covered_pixels"]) < W * H


def test_pt_frame_matches_jax(textured):
    """Two bounces, base-mip taps on the multi-mip arena. The ray counts
    (primary, shadow and bounce rays) may differ by 0.5%: the port's
    surfaces take their normals from the slabs and JAX's CPU path from
    the vertex rows through the instance's normal matrix, so a light
    sample at a grazing angle can pass the front test in one and not the
    other, a shadow ray of almost no contribution (the images agree)."""
    (js, jf, ja, jcam), (scene, tcam) = textured
    jc, jn = j_pt_render_sample(js, jf, ja, jcam, W, H, 2, max_bounces=2,
                                return_stats=True)
    tc, tn = tpt.pt_render_sample(scene, tcam, W, H, 2, 2, return_stats=True,
                                  device="cpu")
    assert abs(int(tn) - int(jn)) <= 5e-3 * int(jn)
    assert _off_share(tc.numpy(), jc) <= 1e-2
    assert (tc.numpy().sum(-1) > 0).mean() > 0.05


def _taps_case(textured, R=3000, seed=5):
    (_, _, ja, _), (scene, _) = textured
    rng = np.random.default_rng(seed)
    T = int(scene["arena"]["n_mips"].shape[0])
    tex = rng.integers(0, T, R).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    lod = rng.uniform(-1, 8, R).astype(np.float32)
    duv = rng.normal(0, 0.05, (R, 2)).astype(np.float32)
    mat = rng.integers(0, int(scene["arena"]["mat_f32"].shape[0]),
                       R).astype(np.int32)
    return ja, scene["arena"], tex, uv, lod, duv, mat


def test_texture_taps_match_jax(textured):
    """sample_trilinear, sample_aniso and sample_material_packed's lod,
    anisotropic and fixed-mip paths over the scene's multi-mip arena."""
    ja, ta, tex, uv, lod, duv, mat = _taps_case(textured)
    t = torch.as_tensor
    for linear in (False, True):
        want = jtexture.sample_trilinear(ja, jnp.asarray(tex), jnp.asarray(uv),
                                         jnp.asarray(lod), linear)
        got = ttexture.sample_trilinear(ta, t(tex), t(uv), t(lod), linear)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        want = jtexture.sample_aniso(ja, jnp.asarray(tex), jnp.asarray(uv),
                                     jnp.asarray(duv), jnp.asarray(lod), 4,
                                     linear)
        got = ttexture.sample_aniso(ta, t(tex), t(uv), t(duv), t(lod), 4,
                                    linear)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for kw in ({"lod": lod - 6}, {"lod": lod - 6, "duv_major": duv,
                                  "aniso_taps": 4},
               {"fixed_mip": 2}, {}):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want = jtexture.sample_material_packed(ja, jnp.asarray(mat),
                                               jnp.asarray(uv), **jkw)
        got = ttexture.sample_material_packed(ta, t(mat), t(uv), **tkw)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{kw} {k}")


def test_bounce_tap_mip_reaches_the_secondary_surfaces(textured,
                                                      monkeypatch):
    """config.policy.bounce_tap_mip > 0 changes the secondary surfaces
    only: a one-bounce frame (primary surfaces alone) stays equal, a
    two-bounce frame changes."""
    from prosper_tpu_torch import config

    _, (scene, tcam) = textured
    frames = {}
    for mip in (0, 3):
        monkeypatch.setattr(config.policy, "bounce_tap_mip", mip)
        frames[mip] = [tpt.pt_render_sample(scene, tcam, W, H, 2, bounces,
                                            device="cpu")
                       for bounces in (1, 2)]
    assert torch.equal(frames[0][0], frames[3][0])
    assert not torch.equal(frames[0][1], frames[3][1])


@pytest.mark.parametrize("aniso_taps", [1, 4])
def test_surfaces_with_a_cone_match_jax(textured, aniso_taps):
    """evaluate_surface with the G-buffer's ray cone over the multi-mip
    arena (trilinear or anisotropic taps at the gathered geometry's LOD)
    against JAX's on the same hits."""
    (js, jf, ja, jcam), (scene, tcam) = textured
    from prosper_tpu_torch.ops.slabs import unpack_hit8
    from prosper_tpu_torch.ops.trace_bvh import trace_closest_bvh

    rng = np.random.default_rng(aniso_taps)
    R = 2000
    eye = tcam["eye"].numpy()
    d = rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    d += -eye / np.linalg.norm(eye)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(eye, (R, 1)).astype(np.float32)
    frame = scene["frame"]
    rows = trace_closest_bvh(scene["geom"]["packed9"], frame["bvh_bounds"],
                             frame["bvh_meta"], torch.as_tensor(o),
                             torch.as_tensor(d), 0.0, float("inf"))
    hit = unpack_hit8(rows)
    valid = hit["tri"].numpy() >= 0
    assert valid.mean() > 0.2
    cone = {"alpha": 0.02, "bias": 0.0, "aniso_taps": aniso_taps}
    got = tsurface.evaluate_surface(scene["static"], frame, scene["arena"],
                                    torch.as_tensor(o), torch.as_tensor(d),
                                    hit, cone=cone)
    want = jsurface.evaluate_surface(
        js, jf, ja, jnp.asarray(o), jnp.asarray(d),
        {k: jnp.asarray(v.numpy()) for k, v in hit.items()}, cone=cone)
    for k in ("albedo", "alpha", "roughness", "metallic", "normal_ws"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_entry_renders_a_gltf_scene(tmp_path):
    """entry(scene=<.gltf>) builds World's scene on the device and returns
    the frame calls of the procedural scenes; bvh=False drops every node
    array, the BVH2 ones and the 8-wide table."""
    path = testing.write_plate_gltf(tmp_path, n_clusters=27, n_instanced=3,
                                    scatter_lights=8)
    fn, (scene, cam, _) = entry("cpu", scene=path, width=32, height=32,
                                mode="deferred", use_culling=True)
    img, state, drawn = fn(scene, cam, 0)
    assert img.shape == (32, 32, 3) and int(drawn) > 0
    frame = scene["frame"]
    assert frame["bvh_nodes8"].shape[1:] == (8, 8)
    assert not set(HOST_ONLY) & set(frame)
    assert int(frame["lights"]["point_count"]) == 8
    assert scene["arena"]["n_mips"].max() > 1
    fn, (scene, cam, _) = entry("cpu", scene=path, width=32, height=32,
                                mode="forward", bvh=False)
    assert not {"bvh_bounds", "bvh_meta", "bvh_nodes8"} & set(scene["frame"])
    img, _, covered = fn(scene, cam, 0)
    assert int(covered) > 0
