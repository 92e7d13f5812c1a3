"""The port's host utilities on the CPU: ops/trace.GeometryCache, the
debug dumps and lines of render/debug.py against prosper_tpu's, the frame
protocol of utils/profiler.Profiler's span store and the per-pass table
of profile_passes.

Exact throughout: the dumps and lines are the same numpy code; the pass
names are the JAX package's jax.named_scope passes (read from its
render modules) or "(other)".
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from prosper_tpu.render import debug as jdebug
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.mathx.transforms import frustum_corners
from prosper_tpu_torch.ops.trace import GeometryCache, prepare_geometry
from prosper_tpu_torch.render import debug as tdebug
from prosper_tpu_torch.scene.camera import Camera, CameraTransform
from prosper_tpu_torch.scene.convert import static_tensors
from prosper_tpu_torch.scene.world import World
from prosper_tpu_torch.utils import profiler as prof
from tests.test_torch_world import T_MID, write_feature_scene

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _jax_scopes(module: str) -> set:
    """The jax.named_scope names of a prosper_tpu render module."""
    text = (REPO / "prosper_tpu" / "render" / f"{module}.py").read_text()
    return set(re.findall(r'named_scope\("(\w+)"\)', text))


def test_geometry_cache_reuses_and_recomputes(tmp_path):
    """The same tensors while the transforms stay; prepare_geometry's
    result anew on an animated frame."""
    w = World(write_feature_scene(tmp_path), use_cache=False)
    static = static_tensors(w.static_scene_arrays(), "cpu")
    cache = GeometryCache()
    f0 = w.frame_arrays(0.0)
    g0 = cache.get(static, f0["transforms"], f0["normal_transforms"])
    again = w.frame_arrays(0.0)
    assert cache.get(static, again["transforms"],
                     again["normal_transforms"]) is g0
    f1 = w.frame_arrays(T_MID)
    assert not np.array_equal(f1["transforms"], f0["transforms"])
    g1 = cache.get(static, f1["transforms"], f1["normal_transforms"])
    assert g1 is not g0
    want = prepare_geometry(static, {
        "transforms": torch.as_tensor(f1["transforms"]),
        "normal_transforms": torch.as_tensor(f1["normal_transforms"])})
    for k in ("packed9", "packed_full", "attr_rows"):
        assert torch.equal(g1[k], want[k]), k


@pytest.mark.parametrize("shape, channel, lo, hi", [
    ((12, 16, 3), "rgb", None, None),
    ((12, 16, 4), "a", None, None),
    ((12, 16, 4), "g", 0.2, 0.7),
    ((12, 16), "rgb", None, None),
    ((12, 16, 1), "r", -1.0, 2.0),
])
def test_dump_texture_matches_jax(tmp_path, shape, channel, lo, hi):
    """The .npy and PNG bytes of dump_texture equal the JAX package's on
    the same array, given as a tensor to the port."""
    a = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jdebug.dump_texture(a, str(tmp_path / "j.png"), channel, lo, hi)
    tdebug.dump_texture(torch.as_tensor(a), str(tmp_path / "t.png"),
                        channel, lo, hi)
    for ext in (".png", ".png.npy"):
        assert (tmp_path / f"t{ext}").read_bytes() == (
            tmp_path / f"j{ext}").read_bytes(), ext


def test_debug_lines_match_jax():
    """DebugLines: lines and a frozen frustum drawn over a frame equal
    the JAX package's; lines behind the camera are skipped."""
    cam = Camera((64, 48))
    cam.look_at(CameraTransform(eye=np.float32([0.5, 1.0, 4.0]),
                                target=np.float32([0, 0, 0]),
                                up=np.float32([0, 1, 0])))
    u = cam.uniforms()
    other = Camera((64, 48))
    other.look_at(CameraTransform(eye=np.float32([0.2, 0.3, 1.0]),
                                  target=np.float32([0, 0, -3]),
                                  up=np.float32([0, 1, 0])))
    ou = other.uniforms()
    corners = frustum_corners(ou["eye"], ou["world_to_camera"], 0.8,
                              64 / 48, 0.1, 2.0)
    img = np.random.default_rng(1).random((48, 64, 3)).astype(np.float32)
    out = []
    for mod in (tdebug, jdebug):
        lines = mod.DebugLines()
        lines.add_line([-1, 0, 0], [1, 0.5, 0], [1, 0, 0])
        lines.add_line([0, 0, 0], [0, 0, 10], [0, 1, 0])  # behind the eye
        lines.add_frustum(corners, [0, 0, 1])
        out.append(lines.rasterize_over(img, u))
        assert len(lines.starts) == 14
        lines.clear()
        assert lines.rasterize_over(img, u) is img
    np.testing.assert_array_equal(out[0], out[1])
    assert (out[0] != img).any()


def test_profiler_frame_protocol():
    """start_frame / spans / end_frame while recording: the frame's
    spans with their kinds, parents and frame index, its report (host
    self ms by span, waits by site) and table, the span cap; outside
    recording no frame is kept."""
    p = prof.Profiler()
    p.start_frame(0)
    assert p.end_frame() is None and p.frames() == []
    with p.recording():
        p.start_frame(7)
        with p.host("render"):
            with p.frame("deferred", 7):
                with p.span("gbuffer"):
                    with p.wait("gbuffer.stack_check"):
                        torch.ones(1000).sum()
                with p.span("shading"):
                    pass
        first = p.end_frame()
        assert [(s.name, s.kind, s.parent) for s in first.spans] == [
            ("render", "host", -1), ("deferred", "frame", 0),
            ("gbuffer", "pass", 1), ("gbuffer.stack_check", "wait", 2),
            ("shading", "pass", 1)]
        assert {s.index for s in first.spans} == {7}
        assert {s.frame for s in first.spans} == {first.id}
        rep = first.report()
        assert rep.index == 7 and rep.frame_ms == first.spans[1].ns / 1e6
        assert rep.waits == {"gbuffer.stack_check":
                             (1, first.spans[3].ns / 1e6)}
        assert sum(rep.self_ms.values()) == pytest.approx(
            first.spans[0].ns / 1e6)
        table = rep.table().splitlines()
        assert table[0].startswith("frame 7:")
        assert table[2].split() == ["render", "host",
                                    f"{rep.self_ms['render', 'host']:.3f}"]
        p.start_frame(8)
        for i in range(prof.MAX_SCOPES + 3):
            with p.host(f"s{i}"):
                pass
        second = p.end_frame()
    assert len(second.spans) == prof.MAX_SCOPES
    assert p.frames() == [first, second] and second.id == first.id + 1
    p.start_frame(9)
    assert p.end_frame() is None


def test_profiler_trace_writes_chrome_json(tmp_path):
    """Spans recorded under a torch.profiler session: a pass span opens
    its record_function range (in the chrome trace beside the operators
    it ran), the frame and wait spans open none."""
    p = prof.Profiler()
    with torch.profiler.profile() as trace:
        with p.frame("pt", 3):
            with p.span("gbuffer"):
                with p.wait("pt.n_rays"):
                    torch.ones(64).cumsum(0)
    trace.export_chrome_trace(str(tmp_path / "trace.json"))
    text = (tmp_path / "trace.json").read_text()
    assert '"gbuffer"' in text and "cumsum" in text
    assert '"pt"' not in text and "pt.n_rays" not in text
    (frame,) = p.frames()
    assert [(s.name, s.kind) for s in frame.spans] == [
        ("pt", "frame"), ("gbuffer", "pass"), ("pt.n_rays", "wait")]
    assert frame.index == 3


@pytest.mark.parametrize("mode, module, kw, needed", [
    ("deferred", "deferred", {"use_culling": True},
     {"gbuffer", "shading", "tonemap", "light_clustering"}),
    ("pt", "pt", {"max_bounces": 2},
     {"primary_trace", "wavefront", "accumulate", "tonemap"}),
    ("restir", "restir", {},
     {"gbuffer", "ris_initial", "spatial_shade", "tonemap"}),
])
def test_profile_passes_names_the_jax_passes(mode, module, kw, needed):
    """The pass table of a 64x64 CPU frame: pass names among the JAX
    package's scopes of that mode (and "(other)"), the main ones present,
    each a share of the frame."""
    fn, (scene, cam, _) = entry("cpu", scene="plate", n_clusters=16,
                                width=64, height=64, mode=mode,
                                scatter_lights=16, **kw)
    _, state, _ = fn(scene, cam, 0)
    rows = prof.profile_passes(lambda: fn(scene, cam, 1, state)[0],
                               frames=2, device="cpu")
    names = {n for n, _ in rows}
    scopes = _jax_scopes(module) | ({"accumulate"} if mode == "restir"
                                    else set())
    assert names <= scopes | {prof.OTHER}, names - scopes
    assert needed <= names
    assert all(ms >= 0 for _, ms in rows) and sum(ms for _, ms in rows) > 0


def _ev(name, device, eid, parent=None, t=(0.0, 0.0)):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device), id=eid,
        cpu_parent=parent, is_async=False, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=t[0], end=t[1]))


def test_pass_table_attributes_kernels_to_outer_scopes():
    """On the card a kernel counts for the outermost pass scope around
    the runtime call that launched it (the host event whose id is the
    kernel's correlation id; operators' ids may take the same numbers); a
    launch outside every scope is "(other)"; the scopes' own device
    ranges and the copies are not kernels."""
    shading = _ev("shading", "CPU", 1)
    nested = _ev("light_clustering", "CPU", 2, parent=shading)
    op = _ev("aten::add", "CPU", 100, parent=nested)
    events = [shading, nested, op,
              _ev("cudaLaunchKernel", "CPU", 100, parent=op),
              _ev("cudaLaunchKernel", "CPU", 101, parent=shading),
              _ev("cuLaunchKernel", "CPU", 102),
              _ev("aten::mul", "CPU", 102, parent=shading),
              _ev("add_kernel", "CUDA", 100, t=(0, 2000)),
              _ev("shade_kernel", "CUDA", 101, t=(2000, 5000)),
              _ev("tonemap_kernel", "CUDA", 102, t=(5000, 5500)),
              _ev("shading", "CUDA", 1, t=(0, 5000)),
              _ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 103,
                  t=(6000, 9000))]
    got = dict(prof.pass_table(events, frames=2, device="cuda"))
    assert got == {"shading": 2.5, prof.OTHER: 0.25}
    assert [k.name for k in prof.device_kernels(events)] == [
        "add_kernel", "shade_kernel", "tonemap_kernel"]
