"""The port's CLI (prosper_tpu_torch/app/cli.py) against the JAX
package's (prosper_tpu/app/cli.py) on the CPU: the parser, the TOML
merge, the helpers, the refusals, an end-to-end render per mode, and the
frames of the two CLIs on one written scene.

The scenes are written by the tests (the quad of tests/test_cli.py and
testing.write_plate_gltf's plates); neither CLI reads the reference
checkout: the JAX CLI's Tony McMapface LUT is patched to the synthetic
LUT the port's CLI takes without a checkout, and its XLA compile cache
is left off. Frames: at most 0.5% of the pixels off by more than 1e-3 +
1e-3 |want| (tests/test_torch_pt.py, tests/test_torch_deferred.py).
"""

import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

from prosper_tpu.app import cli as jcli
from prosper_tpu.ops import tonemap as jtonemap
from prosper_tpu.scene import caches as jcaches
from prosper_tpu_torch import config, testing
from prosper_tpu_torch.app import cli
from prosper_tpu_torch.ops import ibl
from prosper_tpu_torch.ops.tonemap import pack_lut_quads, synthetic_lut
from prosper_tpu_torch.render import distributed
from tests.test_cli import _write_tiny_gltf

torch.set_num_threads(2)
LUT = pack_lut_quads(synthetic_lut())


def _render_actions(parser) -> dict:
    """{dest: (flags, default, choices, nargs, type, const, action class)}
    of the "render" subcommand."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.nargs,
                     a.type, a.const, type(a).__name__)
            for a in sub.choices["render"]._actions
            if not isinstance(a, argparse._HelpAction)}


def _without_scene_default(actions: dict) -> tuple:
    flags, default, *rest = actions.pop("scene")
    return default, (flags, *rest)


def test_parser_matches_jax_cli(tmp_path, monkeypatch):
    """The same flags and defaults but --platform; the default scene is
    the JAX CLI's file inside the checkout $PROSPER_REFERENCE names."""
    monkeypatch.delenv(cli.REFERENCE_ENV, raising=False)
    want = _render_actions(jcli.build_parser())
    want.pop("platform")
    want_scene, want_rest = _without_scene_default(want)
    assert want_scene.endswith("/" + cli.DEFAULT_SCENE_REL)
    for root in (None, str(tmp_path)):
        if root:
            monkeypatch.setenv(cli.REFERENCE_ENV, root)
        got = _render_actions(cli.build_parser())
        assert got.pop("platform")[1:3] == ("gpu", ("gpu", "cpu"))
        scene, rest = _without_scene_default(got)
        assert rest == want_rest and got == want
        assert scene == (os.path.join(root, cli.DEFAULT_SCENE_REL) if root
                         else None)


def test_display_lut_from_the_reference_checkout(tmp_path, monkeypatch):
    """The Tony McMapface DDS of the named checkout, else the synthetic
    LUT (as without a checkout)."""
    from prosper_tpu_torch.ops.tonemap import load_tony_mc_mapface
    from tests.test_torch_io import _words, _write_r9g9b9e5

    monkeypatch.delenv(cli.REFERENCE_ENV, raising=False)
    lut, name = cli._display_lut()
    np.testing.assert_array_equal(lut, LUT)
    monkeypatch.setenv(cli.REFERENCE_ENV, str(tmp_path))
    assert cli._display_lut()[1] == "the synthetic LUT"
    path = tmp_path / cli.TONY_LUT_REL
    path.parent.mkdir(parents=True)
    _write_r9g9b9e5(str(path), _words((48, 48, 48), 3))
    lut, name = cli._display_lut()
    assert name == str(path)
    np.testing.assert_array_equal(lut, load_tony_mc_mapface(str(path)))


@pytest.mark.parametrize("argv, want", [
    ([], {"width": 640, "height": 360, "mode": "pt", "max_bounces": 5}),
    (["--width", "320", "--max-bounces", "2"],
     {"width": 320, "height": 360, "mode": "pt", "max_bounces": 2}),
])
def test_toml_merge_flags_win(tmp_path, argv, want):
    cfg = tmp_path / "cfg.toml"
    cfg.write_text('width = 640\nheight = 360\nmode = "pt"\n'
                   'max-bounces = 5\n')
    argv = ["render", "--config", str(cfg)] + argv
    args = cli.build_parser().parse_args(argv)
    cli._merge_toml(args, argv)
    assert {k: getattr(args, k) for k in want} == want


def test_draw_type_index_and_source_mtimes(tmp_path):
    for name in ("default", "shading_normal", "metallic", "MESH_ID"):
        assert cli._draw_type_index(name) == jcli._draw_type_index(name)
    (tmp_path / "k").mkdir()
    names = ["a.py", "b.cpp", "k/c.cu", "k/d.cuh", "e.txt", "k/f.so"]
    for n in names:
        (tmp_path / n).write_text("x")
    snap = cli._source_mtimes(str(tmp_path))
    assert sorted(os.path.relpath(p, tmp_path) for p in snap) == sorted(
        ["a.py", "b.cpp", os.path.join("k", "c.cu"),
         os.path.join("k", "d.cuh")])
    os.utime(tmp_path / "k" / "c.cu", (1.0, 1.0))
    assert cli._source_mtimes(str(tmp_path)) != snap


@pytest.mark.parametrize("extra, no_card, want", [
    (["--devices", "2", "--platform", "gpu", "--mode", "pt"], False, 2),
    (["--frames", "0", "--platform", "cpu"], False, 2),
    ([], True, 1),
    (None, False, 2),
    (["--devices", "2", "--platform", "cpu", "--mode", "forward"], False, 2),
])
def test_cli_refuses(tmp_path, monkeypatch, extra, no_card, want):
    """--devices N > 1 exits 2 under --platform gpu where torch sees fewer
    than N cards (here: one) and in a mode without a sharded form, as do
    a frame count below 1 and no scene without a reference checkout;
    --platform gpu without a card exits 1; none renders anything, and
    nothing falls back to fewer ranks or to the CPU."""
    monkeypatch.delenv(cli.REFERENCE_ENV, raising=False)
    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if no_card:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "frame.png"
    argv = (["render", str(scene)] + extra if extra is not None
            else ["render", "--platform", "cpu"])
    assert cli.main(argv + ["--out", str(out)]) == want
    assert not out.exists()


@pytest.mark.parametrize("platform, want", [
    ("gpu", {"backend": "nccl", "devices": ["cuda:0", "cuda:1"],
             "threads": None}),
    ("cpu", {"backend": "gloo", "devices": ["cpu", "cpu"]}),
])
def test_cli_starts_the_ranks_it_is_asked_for(tmp_path, monkeypatch,
                                              platform, want):
    """--devices 2 starts two ranks of _render_rank on the platform's
    devices and backend: NCCL on cuda:0 and cuda:1 under --platform gpu
    (torch.cuda patched to see two cards; run_ranks patched, so nothing
    runs), gloo on the CPU under --platform cpu; never one rank, never
    the CPU for gpu."""
    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []

    def run_ranks(worker, world_size, *args, **kwargs):
        calls.append((worker, world_size, kwargs))
        return [0] * world_size

    def single_rank(*args, **kwargs):
        raise AssertionError("--devices 2 rendered on one rank")

    monkeypatch.setattr(distributed, "run_ranks", run_ranks)
    monkeypatch.setattr(cli, "_render", single_rank)
    assert cli.main(["render", str(scene), "--platform", platform,
                     "--mode", "pt", "--devices", "2", "--out",
                     str(tmp_path / "frame.png")]) == 0
    [(worker, world_size, kwargs)] = calls
    assert worker is cli._render_rank and world_size == 2
    assert {k: kwargs[k] for k in want} == want


def _png_ok(path, size):
    img = np.asarray(Image.open(path), np.float32)
    assert img.shape == (size, size, 3)
    assert np.isfinite(img).all() and img.max() > 0 and img.std() > 0


def test_cli_end_to_end_deferred_ibl(tmp_path, monkeypatch):
    """--ibl with the IBL maps at test sizes (the full maps take about a
    minute on the CPU)."""
    monkeypatch.setattr(ibl, "build_ibl", lambda env: {
        "brdf_lut": ibl.integrate_specular_brdf(8, 16),
        "irradiance": ibl.sample_irradiance(env, 4),
        "radiance_mips": ibl.prefilter_radiance(env, 8, n_samples=8)})
    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    out = tmp_path / "frame.png"
    rc = cli.main(["render", str(scene), "--platform", "cpu", "--mode",
                   "deferred", "--ibl", "--env-res", "16", "--width", "64",
                   "--height", "64", "--out", str(out), "--no-cache"])
    assert rc == 0
    _png_ok(out, 64)


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    return testing.write_plate_gltf(tmp_path_factory.mktemp("plates"), 64,
                                    n_instanced=8, scatter_lights=100)


@pytest.mark.parametrize("mode, extra", [
    ("forward", []),
    ("pt", ["--orbit-camera", "--bounce-tracer", "leafmajor"]),
    ("deferred", ["--culling", "--taa", "--autofocus", "--streaming",
                  "--profile", "--profile-device"]),
    ("restir", ["--any-tracer", "dense", "--scatter-lights", "50"]),
])
def test_cli_modes_write_png(plates, tmp_path, capsys, mode, extra):
    """Every mode through main() on the CPU: a finite, non-blank PNG and
    its --dump-debug array; config.policy comes back as it was."""
    saved = (config.policy.any_tracer, config.policy.bounce_tracer)
    out = tmp_path / "frame.png"
    try:
        rc = cli.main(["render", plates, "--platform", "cpu", "--mode", mode,
                       "--width", "32", "--height", "32", "--frames", "3",
                       "--out", str(out), "--dump-debug",
                       str(tmp_path / "dbg.png")] + extra)
    finally:
        config.policy.any_tracer, config.policy.bounce_tracer = saved
    assert rc == 0
    _png_ok(out, 32)
    dbg = np.load(tmp_path / "dbg.png.npy")
    assert dbg.shape == (32, 32, 3) and np.isfinite(dbg).all()
    if "--profile" in extra:
        text = capsys.readouterr().out
        for row in ("gbuffer", "shading", "tonemap", "ATen calls per frame"):
            assert row in text
        # each frame's host spans: the CLI's, the frame call's, its waits
        rows = [ln.split() for ln in text.splitlines()]
        for f in range(3):
            assert any(ln.startswith(f"frame {f}: frame call ")
                       for ln in text.splitlines())
        for span in (["streaming", "host"], ["render", "host"],
                     ["deferred", "frame"], ["gbuffer", "pass"],
                     ["gbuffer.safe_normal", "wait"]):
            assert sum(r[:2] == span for r in rows) == 3, span
        # the load's host spans: each primitive's meshlets (made at load
        # for a streamed World's placeholders)
        load = text.split("scene load:")[1].split("frame 0:")[0]
        assert sum(ln.split()[:2] == ["world.meshlets", "host"]
                   for ln in load.splitlines()) == 1


@pytest.mark.parametrize("mode", ["pt", "deferred"])
def test_cli_frame_matches_jax_cli(plates, tmp_path, monkeypatch, mode):
    """The two CLIs' --dump-debug frames of the same scene and flags."""
    monkeypatch.setattr(jtonemap, "load_tony_mc_mapface", lambda *a: LUT)
    monkeypatch.setattr(jcaches, "enable_compile_cache", lambda *a: None)
    frames = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", cli.main, ["--platform", "cpu"])):
        dump = str(tmp_path / f"{name}.png")
        rc = main(["render", plates, "--mode", mode, "--width", "32",
                   "--height", "32", "--frames", "2", "--no-cache",
                   "--out", str(tmp_path / f"{name}_out.png"),
                   "--dump-debug", dump] + extra)
        assert rc == 0
        frames[name] = np.load(dump + ".npy")
    want, got = frames["jax"], frames["torch"]
    assert got.shape == want.shape == (32, 32, 3)
    off = (np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(-1)
    assert off.mean() <= 0.005, off.mean()


@pytest.mark.parametrize("mode", ["pt", "restir", "deferred"])
def test_cli_sharded_frames_match_one_device(plates, tmp_path, caplog,
                                             mode):
    """--platform cpu --devices 2 (two gloo ranks) renders the frames of
    --devices 1, within atol 1e-5 of the tone-mapped image (they are bit
    for bit the same here). The post and culling flags are dropped with
    the JAX CLI's log line, so the deferred image is the one without
    them."""
    dumps = {}
    for n in (1, 2):
        extra = []
        if n == 2 and mode == "deferred":
            extra = ["--taa", "--bloom", "--dof", "--particles", "--culling"]
        dump = str(tmp_path / f"{n}.png")
        with caplog.at_level("INFO", logger="prosper_tpu_torch"):
            rc = cli.main(["render", plates, "--platform", "cpu", "--mode",
                           mode, "--width", "32", "--height", "32",
                           "--frames", "2", "--devices", str(n), "--out",
                           str(tmp_path / f"{n}_out.png"), "--dump-debug",
                           dump] + extra)
        assert rc == 0
        dumps[n] = np.load(dump + ".npy")
    np.testing.assert_allclose(dumps[2], dumps[1], rtol=0, atol=1e-5)
    _png_ok(tmp_path / "2_out.png", 32)
    dropped = [r.getMessage() for r in caplog.records
               if "sharded mode ignores" in r.getMessage()]
    assert dropped == (["sharded mode ignores post/culling flags: --taa "
                        "--bloom --dof --particles --culling"]
                       if mode == "deferred" else [])
