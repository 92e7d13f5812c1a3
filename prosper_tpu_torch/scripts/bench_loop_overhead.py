"""The fixed costs of loops, on the card.

    python -m prosper_tpu_torch.scripts.bench_loop_overhead

Counterpart of scripts/bench_loop_overhead.py, which timed four Pallas
loops on the TPU's scalar unit to bound the BVH kernel's non-Möller
cost per visit. The same four probes (ops/bench_kernels.py), at the
script's counts:

1. flat: N = 200,000 dependent iterations of a += s[i % 128] (one
   thread, s in shared memory);
2. nested: M = 50,000 outer iterations, each entering an inner loop of
   K = 4 (M * K = N; the kernel's instance with K fixed at compile time,
   as the script's K is a constant);
3. cond: the flat loop with a branch per iteration ((i & 3) == 0);
4. vec: NV = 20,000 iterations of two (2, 128) FMA chains and a min over
   the block (one 256-thread block).

Reports ms per call and ns per iteration (CUDA events); on a CPU device
the plain versions run and no time is taken.
"""

from __future__ import annotations

import torch

from ..ops import bench_kernels as bk

N = 200_000
K = 4
M = N // K
NV = 20_000


def probes(device):
    """name -> (wrapper, input, counts, iterations) at the script's
    counts; the inputs are the script's (s = 0..127, v = ones)."""
    s = torch.arange(128, dtype=torch.int32, device=device)
    v = torch.ones((8, 128), dtype=torch.float32, device=device)
    return {
        "flat": (bk.loop_flat, s, (N,), N),
        "nested": (bk.loop_nested, s, (M, K), N),
        "cond": (bk.loop_cond, s, (N,), N),
        "vec": (bk.loop_vec, v, (NV,), NV),
    }


def main(device="cuda"):
    """Run each probe; returns name -> {"out", "ms", "ns_per_iter"}."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name, (fn, x, counts, iters) in probes(device).items():
        res = fn(x, *counts)
        ms = bk.event_ms(lambda: fn(x, *counts), 5) if on_card else None
        out[name] = {"out": res, "ms": ms,
                     "ns_per_iter": None if ms is None else ms * 1e6 / iters}
        if ms is None:
            print(f"{name:28s}: not measured (no card)")
        else:
            print(f"{name:28s}: {ms:8.3f} ms  "
                  f"({out[name]['ns_per_iter']:7.2f} ns/iter)")
    return out


if __name__ == "__main__":
    main()
