"""Frame-level parity: prosper_tpu_torch's path tracer (plain trace
versions on the CPU) against prosper_tpu's, on the same scenes, cameras
and frame indices.

Pixel tolerance: |port - jax| <= 1e-3 + 1e-3 |jax| per channel, and the
ray counts are equal. Known causes of differing pixels, each allowed a
stated share:
- the port's primary rays come from the kernel's affine raygen, the
  JAX CPU path's from pinhole_rays: a last-ulp direction difference can
  flip a silhouette hit (allowed 0.5%, seen 0 here);
- the Pallas kernels trace bounces with t_min 1e-4, the port with the
  0.0 that render/pt.py passes, so a bounce ray grazing a box edge can
  hit differently (allowed 1% on the kernel path; with t_min 1e-4 in
  the port the frames agree to 1e-5).
"""

from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops.texture import pack_material_tables
from prosper_tpu.render.pt import pt_render_sample as jax_pt_render_sample
from prosper_tpu_torch import config, testing
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.render import pt
from prosper_tpu_torch.scene.convert import from_numpy_scene

torch.set_num_threads(2)
BOUNCES = 2


def _jdev(tree):
    return {
        k: (_jdev(v) if isinstance(v, dict) else jnp.asarray(v))
        for k, v in tree.items()
    }


def _frames(make_scene, n, width, height, frame_index, kernel_path=False,
            port_t_min=None, clamp_indirect=False, bvh=True):
    """(jax color, jax rays, port color, port rays) for one frame; bvh=False
    leaves the BVH arrays out of both packages' frames."""
    static, frame, arena, cam_fn = make_scene(n, 0)
    if not bvh:
        frame = {k: v for k, v in frame.items()
                 if k not in ("bvh_bounds", "bvh_meta")}
    cam = cam_fn(width, height)
    js, jf, ja = _jdev(static), _jdev(frame), _jdev(arena)
    ja["mat_f32"], ja["mat_i32"] = pack_material_tables(js["materials"], ja)
    args = (js, jf, ja, _jdev(cam), width, height, frame_index)
    if kernel_path:
        # the TPU path in Pallas interpret mode (tests/test_alpha.py:84-100)
        orig = pl.pallas_call

        def interp(*a, **k):
            k.setdefault("interpret", True)
            return orig(*a, **k)

        with mock.patch.object(pl, "pallas_call", interp), mock.patch.object(
            jax, "default_backend", lambda: "interpret-tpu"
        ):
            jc, jn = jax_pt_render_sample.__wrapped__(
                *args, max_bounces=BOUNCES, return_stats=True
            )
    else:
        jc, jn = jax_pt_render_sample(*args, max_bounces=BOUNCES,
                                      clamp_indirect=clamp_indirect,
                                      return_stats=True)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    t_min = pt.BOUNCE_T_MIN if port_t_min is None else port_t_min
    with mock.patch.object(pt, "BOUNCE_T_MIN", t_min):
        tc, tn = pt.pt_render_sample(scene, cam, width, height, frame_index,
                                     BOUNCES, clamp_indirect=clamp_indirect,
                                     return_stats=True, device="cpu")
    return np.asarray(jc), int(jn), tc.numpy(), int(tn)


def _off_share(got, want):
    bad = np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)
    return bad.any(axis=-1).mean()


@pytest.mark.parametrize("frame_index,clamp", [(0, False), (3, False),
                                               (3, True)])
def test_frame_matches_jax_cpu_path(frame_index, clamp):
    jc, jn, tc, tn = _frames(testing.make_test_scene, 4, 64, 64, frame_index,
                             clamp_indirect=clamp)
    assert tc.shape == jc.shape == (64 * 64, 3)
    assert tn == jn
    assert (jc.sum(axis=-1) > 0).mean() > 0.05
    assert _off_share(tc, jc) <= 0.005


def test_plate_frame_matches_jax_cpu_path():
    jc, jn, tc, tn = _frames(testing.make_plate_scene, 16, 64, 64, 1)
    assert tn == jn
    assert (jc.sum(axis=-1) > 0).mean() > 0.05
    assert _off_share(tc, jc) <= 0.005


@pytest.mark.parametrize("tracer", ["no_bvh", "bvh_dense"])
def test_plate_frame_tracers_match_jax_cpu_path(tracer, monkeypatch):
    """The frame without BVH arrays (K8 primary and bounce rays, K7
    shadow rays) and with the dense any-hit policy (K10 shadow rays)
    against the JAX CPU frame of the same scene."""
    monkeypatch.setattr(config.policy, "any_tracer",
                        "dense" if tracer == "bvh_dense" else "stack")
    jc, jn, tc, tn = _frames(testing.make_plate_scene, 16, 64, 64, 1,
                             bvh=tracer != "no_bvh")
    assert tn == jn
    assert (jc.sum(axis=-1) > 0).mean() > 0.05
    assert _off_share(tc, jc) <= 0.005


@pytest.mark.parametrize("port_t_min", [None, 1e-4])
def test_frame_matches_jax_kernel_path(port_t_min):
    """16x16 against the Pallas path; with the port's t_min set to the
    Pallas kernels' 1e-4 the differing share drops to none."""
    jc, jn, tc, tn = _frames(testing.make_test_scene, 4, 16, 16, 0,
                             kernel_path=True, port_t_min=port_t_min)
    assert tn == jn
    if port_t_min is None:
        assert _off_share(tc, jc) <= 0.01
    else:
        np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-5)


def test_unported_options_raise():
    """The options that raised before they were ported now render: each
    of use_dof, env and alpha_rounds gives a finite frame that differs
    from the plain one (tests/test_torch_pt_options.py holds them against
    JAX). A scene on another device than the one asked for still
    raises."""
    static, frame, arena, cam_fn = testing.make_plate_scene(
        27, 1, blend_every=4, mask_every=4)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    cam = {**cam_fn(16, 16), "aperture_diameter": np.float32(0.5),
           "focus_distance": np.float32(6.0)}
    plain = pt.pt_render_sample(scene, cam, 16, 16, 0, device="cpu")
    sky = torch.from_numpy(np.full((6, 2, 2, 3), 0.5, np.float32))
    for kw in ({"use_dof": True}, {"env": sky}, {"alpha_rounds": 2}):
        got = pt.pt_render_sample(scene, cam, 16, 16, 0, device="cpu", **kw)
        assert bool(torch.isfinite(got).all())
        assert float((got - plain).abs().amax()) > 1e-3, kw
    with pytest.raises(ValueError, match="not on"):
        pt.pt_render_sample(scene, cam, 16, 16, 0, device="meta")


def test_entry_accumulates_and_tone_maps():
    """Two frames through the entry call: finite display values in
    [0, ~1], a sample count of 2, and a running mean of the samples."""
    fn, (scene, cam, _) = entry("cpu", width=32, height=32, max_bounces=2)
    img0, state0, n0 = fn(scene, cam, 0)
    img1, state1, n1 = fn(scene, cam, 1, state0)
    assert img1.shape == (32, 32, 3) and torch.isfinite(img1).all()
    assert float(img1.min()) >= 0.0 and float(img1.max()) <= 1.5
    assert float(state1[1].min()) == 2.0 and int(n0) > 32 * 32
    s1 = pt.pt_render_sample(scene, cam, 32, 32, 1, 2, device="cpu")
    np.testing.assert_allclose(
        state1[0].numpy(),
        ((state0[0] + s1.reshape(32, 32, 3)) / 2).numpy(),
        rtol=1e-5, atol=1e-6,
    )
