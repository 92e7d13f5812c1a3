"""The span store of utils/profiler.py on the CPU: nesting and self
times, the ring of frames, recording off, the shared clock with
torch.profiler's trace, the frame and pass spans of each mode's entry,
the idle gaps named by span, and the benchmark's readers of the store
(frame_bench/readers/host_*.py, waits_per_frame.py) on a synthetic
store."""

import types

import pytest
import torch

from frame_bench.readers import (
    host_frame_ms,
    host_pass_ms,
    host_wait_ms,
    waits_per_frame,
)
from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.utils import profiler as prof

torch.set_num_threads(2)
MS = 1_000_000  # ns


class Clock:
    """A clock stub: the given times in ns, read in turn; counts reads."""

    def __init__(self, times=()):
        self.times, self.reads = list(times), 0

    def __call__(self):
        self.reads += 1
        return self.times.pop(0) if self.times else 0


def _store(times) -> prof.Profiler:
    p = prof.Profiler(Clock([0] + list(times)))
    p._epoch = 0
    return p


def _two_frames() -> prof.Profiler:
    """Frame 0: 100 ms, spatial_shade 10-60 with a wait 20-30 inside, a
    wait 70-75; frame 1: 50 ms, spatial_shade 200-220, no wait."""
    p = _store([t * MS for t in (0, 10, 20, 30, 60, 70, 75, 100,
                                 200, 200, 220, 250)])
    with p.recording():
        with p.frame("restir", 0):
            with p.span("spatial_shade"):
                with p.wait("restir.stack_check"):
                    pass
            with p.wait("pt.n_rays"):
                pass
        with p.frame("restir", 1):
            with p.span("spatial_shade"):
                pass
    return p


def test_span_nesting_and_self_times():
    p = _two_frames()
    first, second = p.frames()
    assert [(s.name, s.kind, s.parent, s.start_ns, s.end_ns)
            for s in first.spans] == [
        ("restir", "frame", -1, 0, 100 * MS),
        ("spatial_shade", "pass", 0, 10 * MS, 60 * MS),
        ("restir.stack_check", "wait", 1, 20 * MS, 30 * MS),
        ("pt.n_rays", "wait", 0, 70 * MS, 75 * MS)]
    assert first.self_ns() == [45 * MS, 40 * MS, 10 * MS, 5 * MS]
    assert second.self_ns() == [30 * MS, 20 * MS]
    assert (first.index, second.index) == (0, 1)
    assert second.id == first.id + 1
    rep = first.report()
    assert rep.frame_ms == 100.0
    assert rep.self_ms == {("restir", "frame"): 45.0,
                           ("spatial_shade", "pass"): 40.0,
                           ("restir.stack_check", "wait"): 10.0,
                           ("pt.n_rays", "wait"): 5.0}
    assert rep.waits == {"restir.stack_check": (1, 10.0),
                         "pt.n_rays": (1, 5.0)}


def test_frame_span_nests_under_a_frame_the_caller_opened():
    """The CLI's frame: its host spans, the entry's frame span under
    "render", one frame record with the CLI's index."""
    p = prof.Profiler()
    with p.recording():
        p.start_frame(4)
        with p.host("upload"):
            pass
        with p.host("render"):
            with p.frame("pt", 4):
                with p.span("wavefront"):
                    pass
        frame = p.end_frame()
    assert [(s.name, s.kind, s.parent) for s in frame.spans] == [
        ("upload", "host", -1), ("render", "host", -1),
        ("pt", "frame", 1), ("wavefront", "pass", 2)]
    assert p.frames() == [frame] and frame.index == 4


def test_spans_of_another_thread_are_not_recorded():
    """A worker thread's span (a streamed mesh's world.meshlets) while
    the main thread's frame is open is dropped; the main thread's spans
    nest as before."""
    import threading

    p = prof.Profiler()
    with p.recording():
        p.start_frame(0)
        with p.host("streaming"):
            worker = threading.Thread(
                target=lambda: p.host("world.meshlets").__enter__())
            worker.start()
            worker.join()
            with p.host("upload"):
                pass
        frame = p.end_frame()
    assert [(s.name, s.kind, s.parent) for s in frame.spans] == [
        ("streaming", "host", -1), ("upload", "host", 0)]


def test_ring_keeps_the_last_64_frames():
    p = prof.Profiler()
    with p.recording():
        for i in range(prof.RING_FRAMES + 6):
            with p.frame("pt", i):
                pass
    frames = p.frames()
    assert len(frames) == prof.RING_FRAMES == 64
    assert [f.index for f in frames] == list(range(6, 70))
    assert [f.index for f in p.frames(3)] == [67, 68, 69]


def test_recording_off_reads_no_clock(monkeypatch):
    """Outside a torch.profiler session and recording(), no span reads
    the clock or records; a pass span still opens its record_function
    range. The same for a whole frame of the port."""
    clock = Clock()
    p = prof.Profiler(clock)
    reads = clock.reads
    p.start_frame(0)
    with p.frame("pt", 0):
        with p.span("gbuffer") as rf:
            with p.wait("pt.n_rays"), p.host("upload"):
                pass
    assert isinstance(rf, torch.autograd.profiler.record_function)
    assert p.end_frame() is None and p.frames() == []
    assert clock.reads == reads

    fn, (scene, cam, _) = entry("cpu", scene="plate", n_clusters=16,
                                width=64, height=64, mode="pt")
    kept = prof.gprofiler.frames()
    counting = Clock()
    monkeypatch.setattr(prof.gprofiler, "_clock", counting)
    fn(scene, cam, 0)
    assert counting.reads == 0 and prof.gprofiler.frames() == kept


def test_spans_share_the_trace_clock():
    """A span and the record_function range it opens land within 0.1 ms
    of each other on a torch.profiler trace's timeline (event times are
    us after the trace's start, in Unix epoch ns), after one warm call.
    A clock offset shows in every trace; the best of five leaves out a
    worker that was descheduled between the two."""
    p = prof.Profiler()
    gaps = []
    for i in range(6):
        with torch.profiler.profile() as trace:
            with p.frame("pt", i):
                with p.span("gbuffer"):
                    torch.ones(64).cumsum(0)
        start = trace.profiler.kineto_results.trace_start_ns()
        ev = next(e for e in trace.events() if e.name == "gbuffer")
        span = p.frames(1)[0].spans[1]
        assert span.name == "gbuffer"
        gaps.append(max(abs(start + ev.time_range.start * 1e3 - span.start_ns),
                        abs(start + ev.time_range.end * 1e3 - span.end_ns)))
    assert min(gaps[1:]) < 1e5, gaps


@pytest.mark.parametrize("mode, kw, passes", [
    ("pt", {}, {"primary_trace", "wavefront", "accumulate", "tonemap"}),
    ("restir", {"scatter_lights": 16},
     {"gbuffer", "ris_initial", "spatial_shade", "accumulate", "tonemap"}),
    ("deferred", {"use_culling": True, "scatter_lights": 16},
     {"gbuffer", "light_clustering", "shading", "tonemap"}),
])
def test_entry_frame_records_its_passes(mode, kw, passes):
    """A 64x64 frame of each mode under a torch.profiler session: one
    frame span named after the mode, the pass spans that PASS_SCOPES
    names beneath it, every span inside it."""
    fn, (scene, cam, _) = entry("cpu", scene="plate", n_clusters=16,
                                width=64, height=64, mode=mode, **kw)
    _, state, _ = fn(scene, cam, 0)
    prof.gprofiler.clear()
    with torch.profiler.profile():
        fn(scene, cam, 1, state)
    (frame,) = prof.gprofiler.frames()
    top = frame.spans[0]
    assert (top.name, top.kind, top.parent, frame.index) == (
        mode, "frame", -1, 1)
    assert [s for s in frame.spans if s.parent < 0] == [top]
    found = {s.name for s in frame.spans if s.kind == "pass"}
    assert found == passes and found <= set(prof.PASS_SCOPES)
    assert all(s.parent == 0 for s in frame.spans if s.kind == "pass")
    assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
               for s in frame.spans)


def _ev(name, device, start_us, end_us):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device),
        is_user_annotation=False,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_idle_gaps_named_by_the_innermost_span():
    """Gaps between the device's rows (kernels and copies; not the pass
    scopes' annotation rows), each named by the innermost span open at
    its middle, or NO_SPAN."""
    t0 = 10**18
    p = _store([t0 + us * 1000 for us in (0, 5, 12, 18, 25, 100)])
    with p.recording():
        with p.frame("pt", 0):
            with p.span("gbuffer"):
                with p.wait("pt.n_rays"):
                    pass
    events = [_ev("k1", "CUDA", 0, 10), _ev("gbuffer", "CUDA", 0, 200),
              _ev("k2", "CUDA", 20, 30), _ev("Memcpy HtoD", "CUDA", 30, 40),
              _ev("k3", "CUDA", 55, 60), _ev("aten::add", "CPU", 60, 150),
              _ev("k4", "CUDA", 150, 160)]
    got = prof.idle_by_span(events, t0, p.frames())
    assert [(n, k) for n, k, _ in got] == [
        (prof.NO_SPAN, 1), ("pt", 1), ("pt.n_rays", 1)]
    assert [ms for *_, ms in got] == pytest.approx([0.09, 0.015, 0.01])


@pytest.mark.parametrize("reader, want", [
    (host_frame_ms, 67.5), (host_wait_ms, 7.5), (waits_per_frame, 1.0),
    (host_pass_ms, 30.0),
])
def test_span_readers(monkeypatch, reader, want):
    """The benchmark's readers on a synthetic store of two frames; none
    when the window has more frames than the store, or the program keeps
    no store."""
    monkeypatch.setattr(prof, "gprofiler", _two_frames())
    kw = {"scope": "spatial_shade"} if reader is host_pass_ms else {}
    assert reader.read({"window": {"frames": 2}}, **kw) == pytest.approx(want)
    assert reader.read({"window": {"frames": 3}}, **kw) is None
    if reader is host_pass_ms:
        assert reader.read({"window": {"frames": 2}}, scope="dof") is None
    monkeypatch.setattr(prof, "gprofiler", object())
    assert reader.read({"window": {"frames": 2}}, **kw) is None
