"""The runtime policy of the kernel variants.

Counterpart of prosper_tpu/config.py `KernelPolicy` (:22-33) and its
module-level `policy` (:67), with only the knobs whose kernels the port
has. The JAX package reads the fields when a function is traced; the
port reads them at every call (ops/trace.make_tracer), so a field set
between two frames takes effect at the next one.

    from prosper_tpu_torch import config
    config.policy.any_tracer = "dense"
"""

from __future__ import annotations

from dataclasses import dataclass

ANY_TRACERS = ("stack", "dense")


@dataclass
class KernelPolicy:
    # Any-hit (shadow) tracer of ops/trace.make_tracer on frames with BVH
    # node arrays: "stack", the ordered BVH2 walk (K3), or "dense", the
    # packet's cull of every cluster followed by per-ray leaf tests
    # (K10). The JAX package measured stack as its default on the TPU;
    # the port keeps that default.
    any_tracer: str = "stack"


policy = KernelPolicy()
