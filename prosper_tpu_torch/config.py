"""The runtime policy of the kernel variants.

Counterpart of prosper_tpu/config.py `KernelPolicy` (:22-42) and its
module-level `policy` (:67), with only the knobs whose kernels the port
has. The JAX package reads the fields when a function is traced; the
port reads them at every call (ops/trace.make_tracer and
make_bounce_tracer), so a field set between two frames takes effect at
the next one.

    from prosper_tpu_torch import config
    config.policy.any_tracer = "dense"
    config.policy.bounce_tracer = "leafmajor"
    config.policy.bounce_tap_mip = 4
"""

from __future__ import annotations

from dataclasses import dataclass

ANY_TRACERS = ("stack", "dense")
BOUNCE_TRACERS = ("packet", "leafmajor")


@dataclass
class KernelPolicy:
    # Any-hit (shadow) tracer of ops/trace.make_tracer on frames with BVH
    # node arrays: "stack", the ordered BVH2 walk (K3), or "dense", the
    # packet's cull of every cluster followed by per-ray leaf tests
    # (K10). The JAX package measured stack as its default on the TPU;
    # the port keeps that default.
    any_tracer: str = "stack"

    # Tracer of the incoherent rays (the path tracer's bounce and shadow
    # rays, ReSTIR's shadow rays) on frames with BVH node arrays, read by
    # ops/trace.make_bounce_tracer: "packet", the tracers of make_tracer,
    # or "leafmajor", the hybrid of ops/trace_leafmajor.py (exact (ray,
    # leaf) pairs in pair blocks, K14; rays with too many candidates on
    # K2/K3). The JAX package measured packet as its default on the TPU;
    # the port keeps that default.
    bounce_tracer: str = "packet"

    # Texture mip of the path tracer's secondary-bounce surface taps
    # (render/pt.py): 0 samples the base mip, as the reference's
    # derivative-free texture() does; k > 0 samples every texture at mip
    # min(k, n_mips - 1). The JAX package keeps 0 as its default.
    bounce_tap_mip: int = 0


policy = KernelPolicy()
