"""Frame profiler: the span store of the host's work in a frame, and the
per-pass device table of a frame.

Counterpart of prosper_tpu/utils/profiler.py, the analog of the
reference's utils::Profiler (Profiler.hpp:19-327: CPU chrono scopes and
GPU timestamp scopes, at most 512 a frame, shown as a per-scope table):
- `Span`, `Frame`, `FrameReport`, `Profiler` and `gprofiler`: the host
  spans of a frame, kept in memory for the last RING_FRAMES frames. A
  span has a name, a kind ("frame": a mode's frame call; "pass": a
  render pass, which also opens the torch.profiler.record_function
  range of its name that the device tables below read; "wait": a call
  that blocks the host on the device, named after its site; "host": host
  work around the frame call, the CLI's and World's "world.meshlets"),
  its start and end in ns, its parent and its frame's identifier and
  index; only the thread that opened a frame records spans in it (a
  streaming worker's are dropped). Times are on torch.
  profiler's trace clock, the Unix epoch in ns (an event at t us of a
  trace lies at kineto_results.trace_start_ns() + 1000 t), from a
  monotonic clock with an offset fixed when the store is made, so a span
  can be laid among a trace's device rows. Spans are recorded while a
  torch.profiler session runs or inside `gprofiler.recording()` (the
  CLI's --profile); otherwise a span costs a flag test, reads no clock
  and records nothing. A frame's self times (a span's duration less its
  children's) and its waits make its FrameReport; the waits of a frame
  are the program's count of its host-device synchronisations.
- `profile_passes`: the device time of a steady-state frame by render
  pass. The render modules open their pass scopes (PASS_SCOPES, the
  names and places of the JAX package's jax.named_scope passes) through
  gprofiler.span, and one torch.profiler trace of warm frames gives
  every kernel's device time and the host event that launched it; a
  kernel counts for the outermost pass scope around its launch, and
  work outside every scope is "(other)", as `device_pass_table` does
  (:230-262). On the CPU, whose work runs where it is called, the
  profiler's CPU time stands in for device time. The JAX package's HLO
  scope map (`profiled_jit_call`, `capture_jit_calls`, `scope_map_*`,
  :140-200) has no counterpart: the scopes name the passes directly.
- `idle_by_span`: a trace's device idle time named by the innermost
  span open at each gap's middle.
- `device_op_report` and `profile_device_ops` (:287-334): the top device
  kernels by time per run (on the CPU, the top operators by CPU time).

Usage (or inside a torch.profiler session):
    with gprofiler.recording():
        gprofiler.start_frame(0)
        with gprofiler.host("upload"):
            scene = ...
        with gprofiler.host("render"):
            img, state = deferred_entry(...)  # its frame, pass, wait spans
        print(gprofiler.end_frame().report().table())
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

MAX_SCOPES = 512  # spans a frame; a frame's later spans are not recorded
RING_FRAMES = 64  # frames the store keeps

# the pass scopes of the render modules (render/pt.py, deferred.py,
# restir.py), the names of the JAX package's jax.named_scope passes
PASS_SCOPES = (
    "primary_trace", "wavefront", "accumulate", "gbuffer",
    "light_clustering", "shading", "skybox", "transparent", "bloom",
    "particles", "taa", "dof", "tonemap", "ris_initial", "spatial_shade",
)
OTHER = "(other)"
NO_SPAN = "(no span)"
_NULL = contextlib.nullcontext()


@dataclass(slots=True)
class Span:
    name: str
    kind: str  # "frame", "pass", "wait" or "host"
    start_ns: int  # Unix epoch ns, torch.profiler's trace clock
    end_ns: int
    parent: int  # index of the enclosing span in its frame's spans, or -1
    frame: int  # the frame's identifier
    index: int | None  # the frame index

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass(slots=True)
class Frame:
    """One frame's spans, in the order they opened."""

    id: int
    index: int | None
    spans: list

    def self_ns(self) -> list[int]:
        """Each span's self time: its duration less its children's."""
        out = [s.ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.ns
        return out

    def report(self) -> FrameReport:
        self_ms, waits = {}, {}
        for s, ns in zip(self.spans, self.self_ns()):
            key = (s.name, s.kind)
            self_ms[key] = self_ms.get(key, 0.0) + ns / 1e6
            if s.kind == "wait":
                n, ms = waits.get(s.name, (0, 0.0))
                waits[s.name] = (n + 1, ms + s.ns / 1e6)
        frames = [s.ns for s in self.spans if s.kind == "frame"]
        if frames:
            frame_ms = max(frames) / 1e6
        elif self.spans:
            frame_ms = (max(s.end_ns for s in self.spans)
                        - min(s.start_ns for s in self.spans)) / 1e6
        else:
            frame_ms = 0.0
        return FrameReport(self.index, frame_ms, self_ms, waits)


@dataclass
class FrameReport:
    index: int | None
    frame_ms: float  # the frame call's host ms (else the spans' extent)
    self_ms: dict  # (span name, kind) -> host self ms
    waits: dict  # wait site -> (count, ms)

    def table(self) -> str:
        lines = [f"frame {self.index}: frame call {self.frame_ms:.3f} ms "
                 "on the host",
                 f"{'span':<28}{'kind':>8}{'self ms':>10}"]
        lines += [f"{name:<28}{kind:>8}{ms:>10.3f}"
                  for (name, kind), ms in self.self_ms.items()]
        lines.append(f"{'wait site':<28}{'waits':>8}{'ms':>10}")
        lines += [f"{name:<28}{n:>8}{ms:>10.3f}"
                  for name, (n, ms) in self.waits.items()]
        return "\n".join(lines)


class _Span:
    """An open span; with own_frame, it opens and ends its frame."""

    __slots__ = ("_p", "_name", "_kind", "_range", "_index", "_own", "_at")

    def __init__(self, p, name, kind, rf=None, index=None, own_frame=False):
        self._p, self._name, self._kind, self._range = p, name, kind, rf
        self._index, self._own = index, own_frame

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._own:
            self._p.start_frame(self._index)
        self._at = self._p._push(self._name, self._kind)
        return self

    def __exit__(self, *exc):
        self._p._pop(self._at)
        if self._own:
            self._p.end_frame()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Profiler:
    """The span store. clock: a monotonic ns clock (a test's stub)."""

    def __init__(self, clock=time.perf_counter_ns) -> None:
        self._enabled = False  # record outside a torch.profiler session
        self._clock = clock
        self._epoch = time.time_ns() - clock()  # clock -> Unix epoch ns
        self._frames: deque = deque(maxlen=RING_FRAMES)
        self._frame: Frame | None = None
        self._open: list[int] = []
        self._next_id = 0
        self._thread = None  # the thread whose spans the open frame records

    def _recording(self) -> bool:
        return self._enabled or _autograd_profiler._is_profiler_enabled

    @contextlib.contextmanager
    def recording(self, on: bool = True):
        """Record frames inside the block, with or without a
        torch.profiler session (on=False leaves recording as it is)."""
        was = self._enabled
        self._enabled = was or on
        try:
            yield self
        finally:
            self._enabled = was

    # -- frames -----------------------------------------------------------

    def start_frame(self, index: int | None = None) -> None:
        """Open frame `index`'s record when recording is on (a frame left
        open is ended first)."""
        if self._frame is not None:
            self.end_frame()
        if self._recording():
            self._frame = Frame(self._next_id, index, [])
            self._thread = threading.get_ident()
            self._next_id += 1

    def end_frame(self) -> Frame | None:
        """End the open frame (spans left open end now) and keep it in
        the ring; returns it, or None when none was open."""
        frame = self._frame
        if frame is None:
            return None
        if self._open:
            now = self._clock() + self._epoch
            for i in self._open:
                frame.spans[i].end_ns = now
        self._frame, self._open = None, []
        self._frames.append(frame)
        return frame

    def frames(self, n: int | None = None) -> list[Frame]:
        """The last n kept frames (all without n), oldest first."""
        frames = list(self._frames)
        return frames if n is None else frames[max(len(frames) - n, 0):]

    def clear(self) -> None:
        self._frames.clear()

    # -- spans ------------------------------------------------------------

    def frame(self, name: str, index: int):
        """A mode's frame call of frame `index`: nested in the frame the
        caller opened (the CLI's), else its own frame's record."""
        if self._frame is not None:
            return _Span(self, name, "frame")
        if not self._recording():
            return _NULL
        return _Span(self, name, "frame", index=index, own_frame=True)

    def span(self, name: str):
        """A render pass: the record_function(name) range the device
        tables read, and its host span while a frame is recorded."""
        if self._frame is None:
            return record_function(name)
        return _Span(self, name, "pass", record_function(name))

    def wait(self, site: str):
        """A call that blocks the host on the card, named after its site
        (on the CPU the same call, which then waits for nothing)."""
        if self._frame is None:
            return _NULL
        return _Span(self, site, "wait")

    def host(self, name: str):
        """Host work around the frame call (the CLI's, World's)."""
        if self._frame is None:
            return _NULL
        return _Span(self, name, "host")

    def _push(self, name: str, kind: str) -> tuple:
        frame = self._frame
        if (frame is None or len(frame.spans) >= MAX_SCOPES
                or threading.get_ident() != self._thread):
            return None, -1  # spans of another thread would break nesting
        parent = self._open[-1] if self._open else -1
        frame.spans.append(Span(name, kind, self._clock() + self._epoch, 0,
                                parent, frame.id, frame.index))
        i = len(frame.spans) - 1
        self._open.append(i)
        return frame, i

    def _pop(self, at: tuple) -> None:
        frame, i = at
        if i < 0:
            return
        frame.spans[i].end_ns = self._clock() + self._epoch
        if frame is self._frame and i in self._open:
            del self._open[self._open.index(i):]


# the global instance, as utils::gProfiler
gprofiler = Profiler()


# -- per-pass device profiling ----------------------------------------------


def idle_by_span(events, trace_start_ns: int, frames) -> list:
    """[(span name, gaps, idle ms)], largest first: the device's idle
    gaps between its first and last row in a torch.profiler trace (the
    events, whose times are us after trace_start_ns), each named by the
    innermost span of `frames` (recorded during that trace) open at the
    gap's middle, NO_SPAN where none is."""
    from torch.autograd import DeviceType

    busy = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not is_annotation(e))
    spans = [s for f in frames for s in f.spans]
    per = defaultdict(lambda: [0, 0.0])
    end = None
    for a, b in busy:
        if end is not None and a > end:
            mid = trace_start_ns + round((a + end) * 500)
            inner = [s for s in spans if s.start_ns <= mid < s.end_ns]
            row = per[min(inner, key=lambda s: s.ns).name if inner
                      else NO_SPAN]
            row[0] += 1
            row[1] += (a - end) / 1e3
        end = b if end is None else max(end, b)
    return sorted(((name, n, ms) for name, (n, ms) in per.items()),
                  key=lambda r: -r[2])


def activities(device: torch.device):
    from torch.profiler import ProfilerActivity

    if device.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def sync(out) -> None:
    """Wait for the device work behind `out` (a tensor, or a tuple whose
    first item is one); nothing on the CPU."""
    t = out[0] if isinstance(out, tuple) else out
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def is_annotation(e) -> bool:
    """A record_function range copied onto the device timeline."""
    return getattr(e, "is_user_annotation", False) or e.name in PASS_SCOPES


def device_kernels(events) -> list:
    """The kernel events on the CUDA device of a torch.profiler event
    list, without the scopes' annotation ranges and the copies."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not is_annotation(e)
            and not e.name.startswith(("Memcpy", "Memset"))]


def _outer_pass(e) -> str:
    """The outermost pass scope around a host event, or OTHER."""
    name = OTHER
    while e is not None:
        if e.name in PASS_SCOPES:
            name = e.name
        e = e.cpu_parent
    return name


def _is_launch(e) -> bool:
    """A CUDA launch call on the host (cudaLaunchKernel, cuLaunchKernel),
    whose event id is the correlation id of the kernel it launched."""
    return e.name.startswith(("cuda", "cuLaunch"))


def pass_table(events, frames: int = 1, device="cuda") -> list:
    """[(pass, ms per frame)], largest first, from the events of a
    torch.profiler trace over `frames` frames. CUDA: each kernel's device
    time, for the pass around the runtime call that launched it (the
    host event with the kernel's correlation id). CPU: each operator's
    self CPU time, for the pass around it."""
    from torch.autograd import DeviceType

    per = defaultdict(float)
    if torch.device(device).type == "cuda":
        launches = {e.id: e for e in events
                    if e.device_type == DeviceType.CPU and _is_launch(e)}
        for k in device_kernels(events):
            per[_outer_pass(launches.get(k.id))] += (
                k.time_range.end - k.time_range.start) / 1e3
    else:
        for e in events:
            if e.device_type == DeviceType.CPU and not e.is_async:
                per[_outer_pass(e)] += e.self_cpu_time_total / 1e3
    return sorted(((p, ms / max(frames, 1)) for p, ms in per.items()),
                  key=lambda kv: -kv[1])


def _trace(run_frame, force, frames: int, device):
    """The events of a torch.profiler trace over `frames` calls, after
    one warm call outside it."""
    from torch.profiler import profile

    device = torch.device(device)
    force(run_frame())
    with profile(activities=activities(device)) as prof:
        for _ in range(frames):
            force(run_frame())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return prof.events()


def profile_passes(run_frame, force=sync, frames: int = 2, device="cuda"):
    """The pass table of a steady-state frame: run_frame() runs one frame
    (returning its output), force(out) waits for it; one warm call, then
    `frames` calls under the profiler."""
    return pass_table(_trace(run_frame, force, frames, device), frames,
                      device)


def device_op_report(events, top_n: int = 20, runs: int = 1,
                     device="cuda") -> list:
    """[(kernel, ms per run)], the top_n largest, from a torch.profiler
    event list over `runs` runs; on the CPU, operators by self CPU
    time."""
    from torch.autograd import DeviceType

    totals = defaultdict(float)
    if torch.device(device).type == "cuda":
        for k in device_kernels(events):
            totals[k.name] += (k.time_range.end - k.time_range.start) / 1e3
    else:
        for e in events:
            if (e.device_type == DeviceType.CPU and not e.is_async
                    and not is_annotation(e)):
                totals[e.name] += e.self_cpu_time_total / 1e3
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]
    return [(name, ms / max(runs, 1)) for name, ms in top]


def profile_device_ops(fn, force=sync, top_n: int = 20, runs: int = 2,
                       device="cuda") -> list:
    """Trace `runs` warm calls of fn and return the top device kernels."""
    return device_op_report(_trace(fn, force, runs, device), top_n, runs,
                            device)
