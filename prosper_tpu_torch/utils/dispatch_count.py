"""Count a region's launches: the per-frame launch count.

Counterpart of prosper_tpu/utils/dispatch_count.py (`count_dispatches`,
:53-69). The reference submits one command buffer a frame
(App.cpp:1178-1181); a frame whose work leaks into many small launches
serialises through the host without any pixel going wrong, so the count
is held by tests (tests/test_torch_dispatch_budget.py) and printed by
chip_smoke.py beside the frames' profiles.

What is counted:
- device "cuda": the CUDA kernels launched in the region, from a
  torch.profiler trace (CUPTI): the hand-written kernels and PyTorch's
  own, not memory copies or sets, and not the record_function ranges of
  the pass scopes. The `launches` of chip_smoke.py's breakdown.
- device "cpu": the ATen operator calls that reach the dispatcher's
  Python mode (a TorchDispatchMode): what the same code would launch as
  device work, give or take the operators that launch no kernel (views,
  shape queries) and those that launch several.

Neither equals the JAX package's count, the XLA modules a frame
executes: there a frame is a few fused modules; here every PyTorch
operator is at least one kernel.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import torch


@contextmanager
def count_dispatches(result: dict, device="cuda"):
    """`with count_dispatches(out): ...` -> out["n"], the number of
    launches in the block, out["by_name"], a Counter by kernel (CUDA) or
    operator (CPU) name, out["events"], the block's torch.profiler
    events (utils/profiler.pass_table reads them), and
    out["trace_start_ns"], the Unix epoch ns their times count from
    (utils/profiler.idle_by_span lays the host spans among them). On the
    card the block's kernels are waited for before the count is read."""
    from torch.profiler import profile

    from .profiler import activities, device_kernels

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("count_dispatches(device='cuda'): no card")
    names = Counter()
    with profile(activities=activities(device)) as prof:
        if device.type == "cuda":
            yield result
            torch.cuda.synchronize(device)
        else:
            from torch.utils._python_dispatch import TorchDispatchMode

            class _Count(TorchDispatchMode):
                def __torch_dispatch__(self, func, types, args=(),
                                       kwargs=None):
                    names[str(func.overloadpacket)] += 1
                    return func(*args, **(kwargs or {}))

            with _Count():
                yield result
    result["events"] = prof.events()
    result["trace_start_ns"] = prof.profiler.kineto_results.trace_start_ns()
    if device.type == "cuda":
        names.update(k.name for k in device_kernels(result["events"]))
    result["n"] = sum(names.values())
    result["by_name"] = names
