"""Scene inputs and slab contracts of prosper_tpu_torch against
prosper_tpu: scene functions, camera uniforms, pack_tris, pack_tris_full,
attr_rows_from_packed and primary_cam_vec; and a check that the port
never imports JAX or the JAX package."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu import testing as jtesting
from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu.ops import trace_pallas, trace_pallas_full
from prosper_tpu.scene import camera as jcamera
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import slabs, trace_bvh
from prosper_tpu_torch.scene import camera as tcamera
from prosper_tpu_torch.scene.convert import from_numpy_scene

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def _jdev(tree):
    return {
        k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
        for k, v in tree.items()
    }


@pytest.mark.parametrize("n_boxes,seed", [(4, 0), (6, 3)])
def test_make_test_scene_equals_jax(n_boxes, seed):
    """Exact: the function is a line-for-line copy."""
    want = jtesting.make_test_scene(n_boxes, seed)
    got = ttesting.make_test_scene(n_boxes, seed)
    for w, g in zip(want[:3], got[:3]):
        _assert_tree_equal(g, w)
    _assert_tree_equal(got[3](64, 48), want[3](64, 48))


def test_plate_scene_geometry_equals_stress_scene():
    """Exact: make_plate_scene completes make_stress_scene's triangles."""
    tris, wc_min, wc_max, bounds, meta = jtesting.make_stress_scene(27, 1)
    static, frame, arena, cam_fn = ttesting.make_plate_scene(27, 1)
    np.testing.assert_array_equal(static["wt_p0"], tris["v0"])
    np.testing.assert_array_equal(static["wt_p1"] - static["wt_p0"], tris["e1"])
    np.testing.assert_array_equal(static["wt_p2"] - static["wt_p0"], tris["e2"])
    np.testing.assert_array_equal(frame["wc_aabb_min_w"], wc_min)
    np.testing.assert_array_equal(frame["wc_aabb_max_w"], wc_max)
    np.testing.assert_array_equal(frame["bvh_bounds"], bounds)
    np.testing.assert_array_equal(frame["bvh_meta"], meta)
    # every referenced vertex row carries a unit normal and tangent
    rows = static["a_packed"][static["wt_aidx"].reshape(-1)]
    np.testing.assert_allclose(np.linalg.norm(rows[:, 0:3], axis=1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 3:6], axis=1), 1.0,
                               atol=1e-5)
    assert set(np.unique(static["wt_material"])) == {0, 1}
    assert cam_fn(32, 16)["eye"].shape == (3,)


def test_plate_scene_alpha_options():
    """blend_every / mask_every change materials and the arena only: the
    geometry and frame stay those of the plain plate scene, clusters get
    the blend (2) and mask (3) materials by their rules, and the checker
    texture is packed as prosper_tpu.scene.textures packs quads."""
    from prosper_tpu.scene.textures import pack_rgba8_quads

    base = ttesting.make_plate_scene(24, 1)
    static, frame, arena, _ = ttesting.make_plate_scene(24, 1, blend_every=8,
                                                        mask_every=8)
    _assert_tree_equal(frame, base[1])
    for k in ("wt_p0", "wt_p1", "wt_p2", "a_packed", "wt_aidx"):
        np.testing.assert_array_equal(static[k], base[0][k], err_msg=k)
    ci = np.arange(24)
    want = np.where(ci % 8 == 4, 3, np.where(ci % 8 == 7, 2, ci % 2))
    np.testing.assert_array_equal(static["wc_material"], want)
    np.testing.assert_array_equal(static["wt_material"],
                                  np.repeat(want, 128))
    mats = static["materials"]
    np.testing.assert_array_equal(mats["alpha_mode"], [0, 0, 2, 1])
    assert mats["base_color_factor"][2, 3] == 0.5
    assert mats["alpha_cutoff"][3] == 0.5 and mats["base_color_tex"][3] == 1
    off, w, h, _ = arena["table"][1, 0]
    img = np.full((h, w, 4), 255, np.uint8)
    img[..., 3] = np.where(np.add.outer(np.arange(h), np.arange(w)) % 2 == 0,
                           255, 0)
    np.testing.assert_array_equal(arena["data"][off:off + w * h],
                                  pack_rgba8_quads(img))
    np.testing.assert_array_equal(arena["n_mips"], [1, 1])
    # without the options the scene keeps its two opaque materials
    assert len(base[0]["materials"]["alpha_mode"]) == 2


@pytest.mark.parametrize("jitter", [False, True])
def test_camera_uniforms_equal_jax(jitter):
    """Exact: the same numpy math on the same inputs."""
    jt = jcamera.CameraTransform(
        eye=np.array([2.0, 1.5, -3.0], np.float32),
        target=np.array([0.1, 0.2, 0.3], np.float32),
    )
    tt = tcamera.CameraTransform(eye=jt.eye.copy(), target=jt.target.copy())
    want = jcamera.Camera((320, 180), jcamera.CameraParameters(), jt,
                          apply_jitter=jitter).uniforms()
    got = tcamera.Camera((320, 180), tcamera.CameraParameters(), tt,
                         apply_jitter=jitter).uniforms()
    _assert_tree_equal(got, want)


def test_slabs_and_cam_vec_equal_jax():
    """pack_tris / pack_tris_full / attr_rows_from_packed: exact for the
    geometry rows and ids, 1e-6 for renormalised normals and tangents and
    the log2 LOD (float summation order may differ by an ulp).
    primary_cam_vec: 1e-6 relative (the same float32 expressions)."""
    static, frame, arena, cam_fn = ttesting.make_plate_scene(8, 2)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    js, jf = _jdev(static), _jdev(frame)

    want9 = np.asarray(trace_pallas.pack_tris(
        {k: jnp.asarray(v.numpy()) for k, v in scene["geom"]["tris"].items()}
    ))
    np.testing.assert_array_equal(scene["geom"]["packed9"].numpy(), want9)

    want40 = np.asarray(trace_pallas_full.pack_tris_full(js, jf))
    got40 = scene["geom"]["packed_full"].numpy()
    np.testing.assert_array_equal(got40[:, 0:9], want40[:, 0:9])
    np.testing.assert_array_equal(got40[:, 30:37], want40[:, 30:37])
    np.testing.assert_allclose(got40, want40, rtol=1e-6, atol=1e-6)

    want_rows = np.asarray(jtb.attr_rows_from_packed(jnp.asarray(want40)))
    got_rows = slabs.attr_rows_from_packed(torch.tensor(want40)).numpy()
    np.testing.assert_array_equal(got_rows, want_rows)

    cam = cam_fn(96, 64)
    want_cv = np.asarray(jtb.primary_cam_vec(_jdev(cam), 96, 64))
    got_cv = trace_bvh.primary_cam_vec(cam, 96, 64).numpy()
    np.testing.assert_allclose(got_cv, want_cv, rtol=1e-6, atol=1e-7)


def test_hit_row_round_trip_equals_jax():
    """pack_hit16 / unpack_hit16 / unpack_hit8 / attrs_from_hit_rows:
    exact for layouts, 1e-6 for the barycentric blend."""
    rng = np.random.default_rng(3)
    R = 300
    rows = rng.normal(size=(4 * 128, 32)).astype(np.float32)
    rows[:, 27] = rng.integers(0, 5, 4 * 128)
    hit8 = np.zeros((R, 8), np.float32)
    hit8[:, 0] = rng.uniform(0.1, 9, R)
    hit8[:, 1] = rng.integers(-1, 4 * 128, R)
    hit8[:, 2:4] = rng.uniform(0, 0.5, (R, 2))
    want = jtb.attrs_from_hit_rows(jnp.asarray(rows),
                                   jtb.unpack_hit8(jnp.asarray(hit8)))
    got = slabs.attrs_from_hit_rows(torch.as_tensor(rows),
                                    slabs.unpack_hit8(torch.as_tensor(hit8)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    want16 = np.asarray(jtb.pack_hit16(want))
    got16 = slabs.pack_hit16(got).numpy()
    np.testing.assert_allclose(got16, want16, rtol=1e-6, atol=1e-6)
    back = slabs.unpack_hit16(torch.as_tensor(want16))
    jback = jtb.unpack_hit16(jnp.asarray(want16))
    for k in jback:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


def test_port_never_imports_jax():
    """Importing every module of the port (its CLI, utilities and
    streaming included) and rendering a CPU path-traced,
    a CPU deferred and a CPU forward frame (the transparent pass and alpha
    discard on a frame without BVH arrays), two CPU ReSTIR frames, a
    path-traced frame without BVH arrays, one under the leaf-major
    bounce tracer, a deferred frame of a glTF scene written by
    testing.write_plate_gltf and loaded through scene/world.py (glTF,
    native mesh pipeline, textures with mips) and the same file through
    the CLI (streamed, profiled), a path-traced frame with
    its three options (thin-lens DoF, the procedural sky as environment,
    the stochastic alpha retrace) and deferred frames with the CLI's full
    post chain (IBL, TAA, bloom both ways, DoF, particles, culling;
    the IBL maps at test sizes), and the measurement entry points of
    prosper_tpu_torch.experiments and .scripts at a small size pulls in
    no JAX, nothing of prosper_tpu and nothing of the repo's experiments/
    or scripts/."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import prosper_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'prosper_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from prosper_tpu_torch.entry import entry\n"
        "fn, args = entry('cpu', width=32, height=32, max_bounces=2)\n"
        "img, _, n = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(n) > 0\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=8, width=32,\n"
        "                 height=32, mode='deferred', use_culling=True,\n"
        "                 scatter_lights=16)\n"
        "img, state, drawn = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(drawn) > 0\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "                 height=32, mode='forward', scatter_lights=16,\n"
        "                 blend_every=8, mask_every=8, bvh=False)\n"
        "img, state, covered = fn(*args)\n"
        "assert 'bvh_bounds' not in args[0]['frame']\n"
        "assert img.shape == (32, 32, 3) and int(covered) > 0\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "                 height=32, mode='restir', scatter_lights=16)\n"
        "img, state, n_shadow = fn(*args)\n"
        "img, state, n_shadow = fn(args[0], args[1], 1, state)\n"
        "assert img.shape == (32, 32, 3) and float(state[1].max()) == 2.0\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "                 height=32, mode='pt', bvh=False)\n"
        "img, _, n = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(n) > 32 * 32\n"
        "from prosper_tpu_torch import config\n"
        "config.policy.bounce_tracer = 'leafmajor'\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "                 height=32, mode='pt')\n"
        "img, _, n = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(n) > 32 * 32\n"
        "config.policy.bounce_tracer = 'packet'\n"
        "import prosper_tpu_torch.entry as E\n"
        "from prosper_tpu_torch.ops import ibl\n"
        "E.build_ibl = lambda env: {\n"
        "    'brdf_lut': ibl.integrate_specular_brdf(8, 16),\n"
        "    'irradiance': ibl.sample_irradiance(env, 4),\n"
        "    'radiance_mips': ibl.prefilter_radiance(env, 8, n_samples=8)}\n"
        "fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "                 height=32, mode='pt', blend_every=8,\n"
        "                 mask_every=8, ibl=True, env_res=8)\n"
        "img, _, n = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(n) > 32 * 32\n"
        "from prosper_tpu_torch.render import pt\n"
        "c = pt.pt_render_sample(args[0], args[1], 32, 32, 0, 2,\n"
        "    use_dof=True, env=ibl.procedural_sky(8), alpha_rounds=2,\n"
        "    device='cpu')\n"
        "assert c.shape == (32 * 32, 3) and bool(torch.isfinite(c).all())\n"
        "for tech in ('multi_res', 'fft'):\n"
        "    fn, args = entry('cpu', scene='plate', n_clusters=16, width=32,\n"
        "        height=32, mode='deferred', use_culling=True, ibl=True,\n"
        "        env_res=8, use_taa=True, use_bloom=True, use_dof=True,\n"
        "        use_particles=True, bloom_technique=tech, scatter_lights=16)\n"
        "    img, state, drawn = fn(*args)\n"
        "    img, state, drawn = fn(args[0], args[1], 1, state)\n"
        "    assert img.shape == (32, 32, 3) and int(drawn) > 0\n"
        "    assert state['taa_history'] is not None\n"
        "    assert state['particles'] is not None\n"
        "import tempfile\n"
        "from prosper_tpu_torch import testing\n"
        "path = testing.write_plate_gltf(tempfile.mkdtemp(), n_clusters=8,\n"
        "                                n_instanced=2, scatter_lights=4)\n"
        "fn, args = entry('cpu', scene=path, width=32, height=32,\n"
        "                 mode='deferred', use_culling=True)\n"
        "img, state, drawn = fn(*args)\n"
        "assert img.shape == (32, 32, 3) and int(drawn) > 0\n"
        "assert int(args[0]['arena']['n_mips'].max()) > 1\n"
        "from prosper_tpu_torch.app import cli\n"
        "out = tempfile.mkdtemp() + '/frame.png'\n"
        "assert cli.main(['render', path, '--platform', 'cpu', '--mode',\n"
        "    'deferred', '--streaming', '--profile', '--width', '32',\n"
        "    '--height', '32', '--frames', '2', '--out', out]) == 0\n"
        "from prosper_tpu_torch.scripts import bench_visit_breakdown as bvb\n"
        "rec, _ = bvb.main(path, 'cpu', 32, 32)\n"
        "v, need = rec['leaf_visits'], rec['leaves_before_hit']\n"
        "assert v['total'] >= need['total'] > 0\n"
        "from prosper_tpu_torch.experiments import bench_mxu_isect as bmi\n"
        "assert bmi.check('cpu')['agreement'] > bmi.AGREEMENT\n"
        "from prosper_tpu_torch.scripts import bench_loop_overhead as blo\n"
        "assert int(blo.main('cpu')['flat']['out'][0, 0]) == 12697952\n"
        "top = ('jax', 'prosper_tpu', 'experiments', 'scripts')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in top)\n"
        "print(len(sys.modules), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.splitlines()[-1].split(maxsplit=1)
    assert int(n_modules) > 100 and bad.strip() == "[]", out.stdout
