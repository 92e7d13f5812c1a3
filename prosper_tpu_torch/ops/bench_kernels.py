"""Measurement kernels: the triangle-test loops and the loop probes.

Wrappers of csrc/bench_kernels.cu, each with its plain PyTorch version
and a launch counter:

- `isect_loop_moller`, `isect_loop_plucker`, `isect_loop_plucker_pre`
  (X2, experiments/bench_mxu_isect.py run :130, pallas_call :137): a
  256-ray block against one 128-triangle slab, `iters` times, with X2's
  chain best = tmin < -1 ? tmin : best. Möller on the FMA units; Plücker
  with its products on the tensor cores (TF32), rows made from the
  9-row slab in the kernel or given as the 22 feature rows.
- `moller_chain_loop` (X3b, scripts/bench_visit_breakdown.py
  moller_loop_kernel :179, pallas_call :198): Möller with X3b's chain
  best = min(best, tmin + 1e-7), each iteration's t_upper, the
  per-visit Möller cost; the same kernel as X2's Möller loop
  (x2_moller_kernel, four lanes a ray, 1 / det without a branch),
  templated on the chain.
- `loop_flat`, `loop_nested`, `loop_cond`, `loop_vec` (X3c-f,
  scripts/bench_loop_overhead.py :58, :88, :113, :143): loop fixed costs.
  X3d has two kernel instances: the inner trip count K_STATIC fixed at
  compile time (the script's K) and any k read at run time. X3e adds
  runs of COND_RUN iterations, then the rest one by one.

The triangle loops take cols (B, 6, 256) f32, rows ox oy oz dx dy dz of
block b's 256 rays, and return (best (B * 256,), t) with t (B * 256,
128) the last iteration's t (inf on a miss) when keep_t, else None. The
Möller loops equal their plain versions bit for bit (--fmad=false); the
Plücker loops' plain version rounds the products' operands to TF32 as
the kernel does, but the tensor cores sum in their own order, so they
agree on every hit off the border of ops/plucker.tf32_agreement and on t
within a tolerance (chip_smoke.py states it).
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import moller_trumbore
from .plucker import PLU_ROWS, plucker_block_plain, plucker_rows_from_slab
from .trace_bvh import expect_tensor

TILE = 256  # rays per block
LANES = 128  # triangles per slab
T_MIN = 1e-4  # the scripts' t_min (bench_mxu_isect.py:112)
MOLLER, PLUCKER, PLUCKER_PRE = 0, 1, 2
CHAIN_X2, CHAIN_X3B = 0, 1
K_STATIC = 4  # X3d's compile-time inner trip count (K of the script)
COND_RUN = 128  # X3e's iterations a run (csrc/bench_kernels.cu COND_RUN)
PLAIN_BLOCKS = 512  # blocks of rays the plain loops take at once


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps calls after one warm-up, with
    CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cols_from_rays(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, 3) origins and directions, R a multiple of 256 -> cols (R /
    256, 6, 256), the loops' ray layout."""
    x = torch.cat([o, d], dim=1)
    return x.reshape(-1, TILE, 6).transpose(1, 2).contiguous()


def moller_block_plain(slab, o, d, t_min, t_upper):
    """(R, 128) Möller of rays o, d (R, 3) against a (9, 128) slab ->
    (hit, t, u, v), t = inf where missed: trace_pallas._moller_block."""
    hit, t, u, v = moller_trumbore(
        o[:, None, :], d[:, None, :], slab[0:3].T[None], slab[3:6].T[None],
        slab[6:9].T[None], t_min, t_upper)
    return hit, torch.where(hit, t, float("inf")), u, v


def isect_loop_plain(variant: int, chain: int, slab, cols, iters: int,
                     keep_t: bool = False):
    """The triangle loops in PyTorch -> (best, t or None).

    Rays are independent, so PLAIN_BLOCKS blocks run at a time. An
    iteration is a function of best alone: once one leaves best as it
    found it, every later one repeats it, so the loop stops there with
    the result the remaining iterations would give."""
    rows = plucker_rows_from_slab(slab) if variant == PLUCKER else slab
    bests, ts = [], []
    for c in torch.split(cols, PLAIN_BLOCKS):
        o = c[:, 0:3].transpose(1, 2).reshape(-1, 3)
        d = c[:, 3:6].transpose(1, 2).reshape(-1, 3)
        best = torch.full((o.shape[0], 1), float("inf"), dtype=torch.float32,
                          device=o.device)
        t = None
        for _ in range(iters):
            if variant == MOLLER:
                _, t, _, _ = moller_block_plain(slab, o, d, T_MIN, best)
            else:
                _, t, _, _ = plucker_block_plain(rows, o, d, T_MIN, best,
                                                 tf32=True)
            tmin = t.min(dim=1, keepdim=True).values
            if chain == CHAIN_X2:
                new = torch.where(tmin < -1.0, tmin, best)
            else:
                new = torch.minimum(best, tmin + 1e-7)
            fixed = torch.equal(new, best)
            best = new
            if fixed:
                break
        bests.append(best[:, 0])
        ts.append(t)
    t = torch.cat(ts) if keep_t and iters > 0 else None
    return torch.cat(bests), t


_ISECT_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
               ctypes.c_void_p]


def _isect_loop(wrapper, variant, chain, slab, cols, iters, keep_t):
    dev = cols.device
    if dev.type == "cpu":
        return isect_loop_plain(variant, chain, slab, cols, iters, keep_t)
    if dev.type != "cuda":
        raise ValueError(f"isect loop: unsupported device {dev}")
    from . import cuda_build

    n_rows = PLU_ROWS if variant == PLUCKER_PRE else 9
    expect_tensor(slab, "slab", torch.float32, dev, (n_rows, LANES))
    expect_tensor(cols, "cols", torch.float32, dev, (None, 6, TILE))
    if iters < 1:
        raise ValueError(f"isect loop: iters must be >= 1, got {iters}")
    R = cols.shape[0] * TILE
    best = torch.empty((R,), dtype=torch.float32, device=dev)
    t = (torch.empty((R, LANES), dtype=torch.float32, device=dev)
         if keep_t else None)
    cuda_build.launch("bench_kernels", "isect_loop", _ISECT_ARGS, dev, (
        variant, chain, slab.data_ptr(), cols.data_ptr(), cols.shape[0],
        int(iters), T_MIN, best.data_ptr(), 0 if t is None else t.data_ptr()))
    wrapper.launches += 1
    return best, t


def isect_loop_moller(slab, cols, iters: int, keep_t: bool = False):
    """X2 "moller": slab (9, 128) v0 | e1 | e2."""
    return _isect_loop(isect_loop_moller, MOLLER, CHAIN_X2, slab, cols,
                       iters, keep_t)


def isect_loop_plucker(slab, cols, iters: int, keep_t: bool = False):
    """X2 "plucker": slab (9, 128); the feature rows are made in the
    kernel, once per block."""
    return _isect_loop(isect_loop_plucker, PLUCKER, CHAIN_X2, slab, cols,
                       iters, keep_t)


def isect_loop_plucker_pre(rows, cols, iters: int, keep_t: bool = False):
    """X2 "plucker_pre": rows (22, 128) from plucker_rows_from_slab."""
    return _isect_loop(isect_loop_plucker_pre, PLUCKER_PRE, CHAIN_X2, rows,
                       cols, iters, keep_t)


def moller_chain_loop(slab, cols, iters: int, keep_t: bool = False):
    """X3b: Möller with best = min(best, tmin + 1e-7); slab (9, 128)."""
    return _isect_loop(moller_chain_loop, MOLLER, CHAIN_X3B, slab, cols,
                       iters, keep_t)


# ---------------------------------------------------------------------------
# The loop probes: s (128,) int32, out (8, 128) int32 (v (8, 128) f32 and
# an f32 out for the vector probe)


def _wrap_i32(total: torch.Tensor) -> torch.Tensor:
    """An int64 sum -> int32 modulo 2^32, as the kernels' sums wrap."""
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def _fill(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(1, 1).expand(8, 128).contiguous()


def loop_flat_plain(s, n: int):
    """sum of s[i % 128] over i < n."""
    i = torch.arange(n, device=s.device)
    return _fill(_wrap_i32(s.long()[i % 128].sum()))


def loop_nested_plain(s, m: int, k: int):
    """The flat sum over m * k iterations, as m loops of k."""
    return loop_flat_plain(s, m * k)


def loop_cond_plain(s, n: int):
    """sum over i < n of s[i % 128] where i % 4 == 0, else 1."""
    i = torch.arange(n, device=s.device)
    v = torch.where(i % 4 == 0, s.long()[i % 128], 1)
    return _fill(_wrap_i32(v.sum()))


def loop_vec_plain(v, nv: int):
    """a += min((v[0:2] - a) * v[2:4], (v[4:6] - a) * v[6:8]), nv times."""
    a = torch.zeros((), dtype=torch.float32, device=v.device)
    for _ in range(nv):
        e = torch.minimum((v[0:2] - a) * v[2:4], (v[4:6] - a) * v[6:8])
        a = a + e.min()
    return _fill(a)


_PROBE_ARGS = {
    "loop_flat": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "loop_nested": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p],
    "loop_cond": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "loop_vec": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}


def _probe(wrapper, x, counts, plain):
    name = wrapper.__name__
    dev = x.device
    if dev.type == "cpu":
        return plain(x, *counts)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    from . import cuda_build

    if name == "loop_vec":
        expect_tensor(x, "v", torch.float32, dev, (8, 128))
    else:
        expect_tensor(x, "s", torch.int32, dev, (128,))
    out = torch.empty((8, 128), dtype=x.dtype, device=dev)
    cuda_build.launch("bench_kernels", name, _PROBE_ARGS[name], dev,
                      (x.data_ptr(), *map(int, counts), out.data_ptr()))
    wrapper.launches += 1
    return out


def loop_flat(s, n: int):
    """X3c: n dependent iterations of a += s[i % 128]."""
    return _probe(loop_flat, s, (n,), loop_flat_plain)


def nested_instance(k: int, instance=None) -> int:
    """The loop_nested_kernel instance that runs k trips an entry: the
    compile-time K_STATIC for k == K_STATIC, else the generic 0; an
    explicit instance is K_STATIC (k must equal it) or 0."""
    if instance is None:
        return K_STATIC if k == K_STATIC else 0
    if instance not in (0, K_STATIC) or (instance and k != instance):
        raise ValueError(f"loop_nested: no instance {instance} for k = {k}")
    return instance


def loop_nested(s, m: int, k: int, instance=None):
    """X3d: m outer iterations, each entering an inner loop of k; on the
    card the kernel instance nested_instance(k, instance) runs."""
    kt = nested_instance(k, instance)
    return _probe(loop_nested, s, (m, k, kt),
                  lambda x, m, k, _: loop_nested_plain(x, m, k))


def loop_cond(s, n: int):
    """X3e: the flat loop with a branch per iteration."""
    return _probe(loop_cond, s, (n,), loop_cond_plain)


def loop_vec(v, nv: int):
    """X3f: nv iterations of two (2, 128) FMA chains and a block min."""
    return _probe(loop_vec, v, (nv,), loop_vec_plain)


KERNELS = (isect_loop_moller, isect_loop_plucker, isect_loop_plucker_pre,
           moller_chain_loop, loop_flat, loop_nested, loop_cond, loop_vec)
for _fn in KERNELS:
    _fn.launches = 0
