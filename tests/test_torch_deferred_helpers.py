"""The deferred path's small modules of prosper_tpu_torch against their
prosper_tpu counterparts: the G-buffer encodings, the directional light,
the ray-cone spread, the froxel z-slices, the BVH builder and light
uniforms the port copies, and the mode table.

Tolerances: integer outputs (slice indices, BVH arrays, packed rows)
exact; float32 expressions that both packages write alike within 1e-6
(1e-5 after a normalisation, whose sum XLA and PyTorch may order
differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.accel import bvh as jbvh
from prosper_tpu.mathx import packing as jpacking
from prosper_tpu.ops import clustering as jclustering
from prosper_tpu.render import shading as jshading
from prosper_tpu.render import surface as jsurface
from prosper_tpu.scene import lights as jlights
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.accel import bvh as tbvh
from prosper_tpu_torch.mathx import packing as tpacking
from prosper_tpu_torch.ops import clustering as tclustering
from prosper_tpu_torch.render import frame as tframe
from prosper_tpu_torch.render import shading as tshading
from prosper_tpu_torch.render import surface as tsurface
from prosper_tpu_torch.scene import lights as tlights
from prosper_tpu_torch.scene.convert import from_numpy_scene

torch.set_num_threads(2)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_signed_oct_and_velocity_equal_jax():
    rng = np.random.default_rng(0)
    n = _unit(rng, 1000)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    want = np.asarray(jpacking.signed_oct_encode(jnp.asarray(n)))
    got = tpacking.signed_oct_encode(torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    back = tpacking.signed_oct_decode(torch.tensor(want)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jpacking.signed_oct_decode(jnp.asarray(want))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(back, n, atol=1e-5)
    v = rng.normal(scale=2.0, size=(500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tpacking.pack_velocity(torch.as_tensor(v)).numpy(),
        np.asarray(jpacking.pack_velocity(jnp.asarray(v))))


def test_directional_light_equals_jax():
    rng = np.random.default_rng(1)
    R = 700
    surface = {
        "position_ws": rng.normal(size=(R, 3)).astype(np.float32),
        "normal_ws": _unit(rng, R),
        "inv_view_ray": _unit(rng, R),
        "albedo": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "roughness": rng.uniform(0.05, 1, R).astype(np.float32),
        "metallic": rng.uniform(0, 1, R).astype(np.float32),
    }
    lights = {"dir_direction": np.array([-1.0, -2.0, 0.5], np.float32),
              "dir_irradiance": np.array([2.0, 1.5, 1.0], np.float32)}
    want = np.asarray(jshading.eval_directional_light(
        {k: jnp.asarray(v) for k, v in surface.items()},
        {k: jnp.asarray(v) for k, v in lights.items()}))
    got = tshading.eval_directional_light(
        {k: torch.as_tensor(v) for k, v in surface.items()},
        {k: torch.as_tensor(v) for k, v in lights.items()}).numpy()
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pixel_cone_and_mip_check():
    """The spread equals JAX's. A cone's LOD on the one-mip arena of the
    procedural scenes samples the base mip (the trilinear tap clamps the
    LOD to [0, n_mips - 1]); on a mipped texture the trilinear taps equal
    JAX's within 1e-6 (the multi-mip arena no longer raises)."""
    from prosper_tpu.ops import texture as jtexture
    from prosper_tpu_torch.ops import texture as ttexture
    from prosper_tpu_torch.scene.textures import generate_mips, pack_rgba8_quads

    static, frame, arena, cam_fn = ttesting.make_test_scene(4)
    cam = cam_fn(64, 48)
    want = float(jsurface.pixel_cone_alpha(
        {k: jnp.asarray(v) for k, v in cam.items()}, 48))
    got = float(tsurface.pixel_cone_alpha(
        {k: torch.as_tensor(v) for k, v in cam.items()}, 48))
    assert got == pytest.approx(want, rel=1e-6)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(0)
    mat = torch.ones(500, dtype=torch.int32)
    uv = torch.as_tensor(rng.uniform(-1, 2, (500, 2)), dtype=torch.float32)
    lod = torch.as_tensor(rng.uniform(-3, 6, 500), dtype=torch.float32)
    base = ttexture.sample_material_packed(scene["arena"], mat, uv)
    coned = ttexture.sample_material_packed(scene["arena"], mat, uv, lod=lod)
    for k in base:
        torch.testing.assert_close(coned[k], base[k], rtol=0, atol=0)

    img = rng.integers(0, 256, (16, 8, 4)).astype(np.uint8)
    mips = generate_mips(img, srgb=True)
    offs = np.cumsum([0] + [m.shape[0] * m.shape[1] for m in mips])
    table = np.zeros((1, 13, 4), np.int32)
    for m, mip in enumerate(mips):
        table[0, m] = (offs[m], mip.shape[1], mip.shape[0], 1)
    table[0, len(mips):] = table[0, len(mips) - 1]
    mipped = {"data": np.concatenate([pack_rgba8_quads(m) for m in mips]),
              "table": table, "n_mips": np.int32([len(mips)])}
    tex = np.zeros(500, np.int32)
    want = jtexture.sample_trilinear(
        {k: jnp.asarray(v) for k, v in mipped.items()}, jnp.asarray(tex),
        jnp.asarray(uv.numpy()), jnp.asarray(lod.numpy()))
    got = ttexture.sample_trilinear(
        {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32
                            else v) for k, v in mipped.items()},
        torch.as_tensor(tex), uv, lod)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_z_slices_equal_jax():
    near, far = np.float32(0.1), np.float32(400.0)
    np.testing.assert_allclose(
        tclustering.slice_starts(torch.tensor(near), torch.tensor(far)),
        np.asarray(jclustering.slice_starts(jnp.asarray(near),
                                            jnp.asarray(far))),
        rtol=1e-6)
    z = -np.geomspace(0.01, 1000.0, 5000).astype(np.float32)
    np.testing.assert_array_equal(
        tclustering.cluster_index_z(torch.as_tensor(z), near, far).numpy(),
        np.asarray(jclustering.cluster_index_z(jnp.asarray(z), near, far)))
    # no surface (z = -inf): the last slice, not an undefined conversion
    inf = tclustering.cluster_index_z(torch.tensor([-np.inf]), near, far)
    assert int(inf[0]) == tclustering.Z_SLICE_COUNT - 1
    for name in ("LIGHT_CLUSTER_DIMENSION", "Z_SLICE_COUNT",
                 "MAX_POINT_INDICES", "MAX_SPOT_INDICES"):
        assert getattr(tclustering, name) == getattr(jclustering, name)


@pytest.mark.parametrize("n,leaf", [(1, 1), (37, 1), (300, 1), (300, 4)])
def test_bvh_copy_equals_jax(n, leaf):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 2, (n, 3)).astype(np.float32)
    want = jbvh.build_bvh(lo, hi, max_leaf_size=leaf)
    got = tbvh.build_bvh(lo, hi, max_leaf_size=leaf)
    for f in ("nodes_min", "nodes_max", "nodes_left", "nodes_right",
              "nodes_first", "nodes_count", "order"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.depth == want.depth
    if leaf == 1:
        for g, w in zip(tbvh.pack_nodes(got), jbvh.pack_nodes(want)):
            np.testing.assert_array_equal(g, w)


def test_light_uniforms_copy_equals_jax():
    rng = np.random.default_rng(4)
    la_t, la_j = tlights.LightArrays(), jlights.LightArrays()
    assert (tlights.MAX_POINT_LIGHTS, tlights.MAX_SPOT_LIGHTS) == (
        jlights.MAX_POINT_LIGHTS, jlights.MAX_SPOT_LIGHTS)
    for f in ("point_radiance", "point_position", "spot_radiance",
              "spot_position", "spot_direction"):
        v = rng.normal(size=getattr(la_t, f).shape).astype(np.float32)
        setattr(la_t, f, v)
        setattr(la_j, f, v.copy())
    for f in ("point_radius", "spot_angle_scale", "spot_angle_offset"):
        v = rng.uniform(0.1, 3, getattr(la_t, f).shape).astype(np.float32)
        setattr(la_t, f, v)
        setattr(la_j, f, v.copy())
    la_t.point_count = la_j.point_count = 37
    la_t.spot_count = la_j.spot_count = 5
    want = jlights.light_uniforms(la_j)
    got = tlights.light_uniforms(la_t)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_render_modes():
    modes = tframe.render_modes()
    assert sorted(modes) == ["deferred", "forward", "pt", "restir"]
    assert modes["deferred"].__name__ == "deferred_entry"
    assert modes["forward"].__name__ == "forward_entry"
    assert modes["restir"].__name__ == "restir_entry"
