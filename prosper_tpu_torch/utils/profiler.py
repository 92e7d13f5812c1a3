"""Frame profiler: matched host and device timing scopes with a per-frame
report, and the per-pass device table of a frame.

Counterpart of prosper_tpu/utils/profiler.py, the analog of the
reference's utils::Profiler (Profiler.hpp:19-327: GPU timestamp scopes
matched one to one with CPU chrono scopes, read back a frame later, at
most 512 scopes, shown as a per-scope table):
- `ScopeData`, `FrameReport`, `Profiler` and `gprofiler` (:33-137): a
  scope times its host section with perf_counter; with sync_device on a
  CUDA device its device ms come from a pair of CUDA events around it
  (the JAX package fences with block_until_ready); `previous()` keeps the
  one-frame-late report; start_trace/stop_trace write a torch.profiler
  trace (chrome JSON) into a directory.
- `profile_passes` (:265-284): the device time of a steady-state frame
  by render pass. The port's render modules open
  torch.profiler.record_function scopes under the names and at the
  places of the JAX package's jax.named_scope passes (PASS_SCOPES), and
  one torch.profiler trace of warm frames gives every kernel's device
  time and the host event that launched it; a kernel counts for the
  outermost pass scope around its launch, and work outside every scope
  is "(other)", as `device_pass_table` does (:230-262). On the CPU, whose
  work runs where it is called, the profiler's CPU time stands in for
  device time. The JAX package's HLO scope map (`profiled_jit_call`,
  `capture_jit_calls`, `scope_map_*`, :140-200) has no counterpart: the
  scopes name the passes directly.
- `device_op_report` and `profile_device_ops` (:287-334): the top device
  kernels by time per run (on the CPU, the top operators by CPU time).

Usage:
    gprofiler.start_frame()
    with gprofiler.scope("GBuffer"):
        gbuf = render_gbuffer(...)
    report = gprofiler.end_frame()
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

MAX_SCOPES = 512

# the pass scopes of the render modules (render/pt.py, deferred.py,
# restir.py), the names of the JAX package's jax.named_scope passes
PASS_SCOPES = (
    "primary_trace", "wavefront", "accumulate", "gbuffer",
    "light_clustering", "shading", "skybox", "transparent", "bloom",
    "particles", "taa", "dof", "tonemap", "ris_initial", "spatial_shade",
)
OTHER = "(other)"


@dataclass
class ScopeData:
    name: str
    cpu_ms: float = 0.0
    device_ms: float = 0.0
    count: int = 0


@dataclass
class FrameReport:
    scopes: list[ScopeData] = field(default_factory=list)
    frame_cpu_ms: float = 0.0

    def table(self) -> str:
        lines = [f"{'scope':<28}{'cpu ms':>10}{'device ms':>12}"]
        for s in self.scopes:
            lines.append(f"{s.name:<28}{s.cpu_ms:>10.2f}{s.device_ms:>12.2f}")
        lines.append(f"{'frame':<28}{self.frame_cpu_ms:>10.2f}")
        return "\n".join(lines)


class Profiler:
    """Per-frame scopes. sync_device: time each scope's device work too,
    waiting for it at the scope's end (profiling mode); otherwise scopes
    time the host alone and never wait for the device."""

    def __init__(self, sync_device: bool = False, device="cuda") -> None:
        self.sync_device = sync_device
        self.device = torch.device(device)
        self._scopes: list[ScopeData] = []
        self._frame_start = 0.0
        self._previous: FrameReport | None = None
        self._trace = None
        self._trace_dir: str | None = None

    # -- frame protocol (Profiler::startCpuFrame/endFrame analog) --------

    def start_frame(self) -> None:
        self._scopes = []
        self._frame_start = time.perf_counter()

    def end_frame(self) -> FrameReport:
        report = FrameReport(
            scopes=self._scopes,
            frame_cpu_ms=(time.perf_counter() - self._frame_start) * 1e3,
        )
        self._previous = report
        return report

    def previous(self) -> FrameReport | None:
        """The last finished frame's report, like the reference's
        one-frame-late query readback."""
        return self._previous

    # -- scopes -----------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, name: str):
        """A host + device scope; beyond MAX_SCOPES a frame's scopes are
        not recorded."""
        if len(self._scopes) >= MAX_SCOPES:
            yield
            return
        data = ScopeData(name=name)
        events = None
        if self.sync_device and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        yield
        data.cpu_ms = (time.perf_counter() - t0) * 1e3
        if events is not None:
            events[1].record()
            events[1].synchronize()
            data.device_ms = events[0].elapsed_time(events[1])
        elif self.sync_device:  # the CPU's work is done when it returns
            data.device_ms = data.cpu_ms
        data.count = 1
        self._scopes.append(data)

    # -- deep tracing -------------------------------------------------------

    def start_trace(self, log_dir: str) -> None:
        from torch.profiler import profile

        self._trace_dir = log_dir
        self._trace = profile(activities=activities(self.device))
        self._trace.__enter__()

    def stop_trace(self) -> None:
        """End the trace and write it as log_dir/trace.json."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._trace.__exit__(None, None, None)
        os.makedirs(self._trace_dir, exist_ok=True)
        self._trace.export_chrome_trace(
            os.path.join(self._trace_dir, "trace.json"))
        self._trace = self._trace_dir = None


# the global instance, as utils::gProfiler
gprofiler = Profiler()


# -- per-pass device profiling ----------------------------------------------


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
