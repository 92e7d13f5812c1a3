"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives prosper_tpu_torch's four ported paths at 1920x1080 on the
2048-cluster plate scene (262,144 triangles) through the hand-written
CUDA kernels: the wavefront path tracer (3 bounces), with and without
BVH arrays, the deferred renderer (G-buffer, 1024 scattered point
lights, clustered tile shading), without and with two-phase meshlet
culling, the forward renderer with its transparent pass and alpha-mask
discard, ReSTIR DI under its three tracer configurations, the path
tracer and ReSTIR under the leaf-major bounce tracer, and the glTF
scene path: the plate scene written as a glTF file, loaded through
World, rendered, and traced by the 8-wide kernels, and the measurement
entry points of the experiments and scripts (X1-X3). Phases:

1. device: CUDA, nvcc and the card's name and power limit;
2. build: compile csrc/trace_bvh.cu, csrc/shade_tiles.cu,
   csrc/trace_flat.cu, csrc/trace_leafmajor.cu, csrc/trace_wavefront.cu
   and csrc/bench_kernels.cu for sm_90a, one nvcc each, in parallel
   (timed), and print the ptxas line (registers, stack frame, spills)
   of K1-K4 (the warp walk) and X3a (the one-thread walk);
3. kernels: each kernel against its plain PyTorch version on the card,
   on the whole inputs of one frame, with kernel and plain times and
   the bound (the least time an H100 could take for the same work):
   K1 on every primary ray of the path tracer and on every pixel of the
   G-buffer, K2 on the first bounce set (also against X3a, the
   one-thread walk: rows 0-5 equal bit for bit, both timed), K3 on the
   first shadow set, K4 on both culling phases of a culled G-buffer, K5
   on the G-buffer of a deferred frame; K1 and K4 also against the
   one-thread walk on the same rays, bit for bit (K1: X3a's rows 0-3 on
   raygen_plain's rays, through the attribute interpolation; K4's
   masked phases: the lockstep plain walk with the same mask), with
   X3a's time on the same unmasked rays beside theirs;
4. pt: the path tracer's frame call (sample, accumulate, tone map), 2
   warm-up + 8 timed frames, launch counts, memory, a profile of one
   frame; the CUDA frame against the CPU frame on the 64x64 test scene;
   the 1080p frame with the plain versions against the kernels' frame;
5. deferred: the deferred frame call without and with culling, each 2
   warm-up + 8 timed frames with launch counts, drawn meshlets, memory
   and a profile of one frame; the culled G-buffer against the unculled
   one; each 1080p frame with the plain versions against the kernels'
   frame; 64x64 CUDA frames against CPU frames;
6. kernels: flat: K6 on the opaque pass's rays of a forward frame of
   the blend/mask scene (make_plate_scene(..., blend_every=8,
   mask_every=8): masked AABBs) and on its first alpha retrace, against
   its plain version; K6 over the unmasked AABBs against K2 on the same
   rays; K8 on the G-buffer rays of a frame without BVH arrays,
   unculled (against its plain version and K1) and in both culling
   phases (against its plain version and K4 with the same masks);
7. forward: (a) forward on the opaque scene, (b) forward on the
   blend/mask scene (transparent pass, two alpha-discard rounds, the
   CLI's flags), (c) the culled deferred frame of the blend/mask scene
   without BVH arrays; each 2 warm-up + 8 timed frames with launch
   counts, memory and a profile of one frame, the 1080p frame with the
   plain versions against the kernels' frame, and 64x64 CUDA frames
   against CPU frames;
8. kernels: any hit: the shadow rays of one ReSTIR frame with BVH arrays
   (plate-2048 + 1024 lights) and of one without; K10 on the first
   against its plain version and K3, K7 on the second against its plain
   version and K3, K3 on both;
9. restir: ReSTIR DI with BVH arrays under config.policy.any_tracer
   "stack" (K1, K3) and "dense" (K1, K10), and without BVH arrays (K8,
   K7); each 2 warm-up + 8 timed frames with launch counts, shadow-ray
   counts, memory and a profile of one frame, the 1080p frame with the
   plain versions against the kernels' frame, and 64x64 CUDA frames
   against CPU frames;
10. pt bvh=False: the path tracer without BVH arrays (K8 primary and
   bounce rays, K7 shadow rays): K8 on its first bounce set and K7 on
   its first shadow set against their plain versions, then checked as
   phase 4 checks its frame;
11. kernels: leaf-major: the first bounce and shadow sets of a
   path-traced frame and the shadow set of a ReSTIR frame, as the frames
   hand them to the hybrid under config.policy.bounce_tracer =
   "leafmajor": their heavy shares, tiles over VIS_CAP, valid pairs and
   blocks; K14 against its plain version on the hybrid's pair blocks and
   on the blocks of every ray's first 8 candidates (closest hit on the
   bounce set, any hit on the shadow sets); the hybrid against K2 or K3
   on the same rays; K9 on the bounce set against its plain version and
   K2, without and with a random skip mask;
12. leafmajor: the path tracer (K1, K14, K2, K3) and ReSTIR (K1, K14,
   K3) under "leafmajor", each checked as phase 9 checks its frames; the
   policy is restored after the phase;
13. world: testing.write_plate_gltf writes the plate scene's 262,144
   triangles (two meshes, one instanced by 64 TRS nodes under a parent),
   its 1024 scattered lights (KHR_lights_punctual), its camera and three
   PNG textures into a temporary directory; scene/world.py `World` loads
   it with the native mesh library (timed: load, texture arena,
   frame_arrays with pack_nodes8); then the path tracer (3 bounces: K1,
   K2, K3) and the culled deferred frame (K1/K4, K5) on it through
   entry(scene=<path>), each checked as phase 4 checks its frame (the
   64x64 frames on a 64-plate glTF), the PT frame's K1-K3 and the
   deferred frame's K4 phases as phase 3 checks them;
14. kernels: 8-wide: the World's 8-wide table on the rays of
   scripts/bench_bvh8.py: K12 on the 1080p block-order pinhole rays
   against its plain version and K4 (K4 there also against X3a, as phase
   3); on the cosine bounce set from
   those hits (sorted by cluster and octant) K11 against its plain
   version and K2, K12 against its plain version and K4, and, with t_max
   8, K13 against its plain version and K3; each with its time, the
   plain version's and the BVH2 kernel's on the same rays;
15. kernels: experiments: the port's measurement entry points, run while
   the World file still exists: scripts/bench_visit_breakdown.main on
   plate-2048 and on the World (K4 primary rays, the cosine bounce set,
   the counting K2 X3a, K2's time, the threaded walk X1 at each ray's hit
   t and t_max, the Möller unit X3b), experiments/bench_mxu_isect.main
   (the Möller block against the tensor-core Plücker block, then the three
   X2 loops at one block and at 8 blocks per SM) and
   scripts/bench_loop_overhead.main (X3c-f); then X1, X3a, the Möller
   loops and X3c-f against their plain versions (equal) on the shapes the
   entry points ran, the Plücker loops against their TF32 plain version
   (no hit/miss mismatch off ops/plucker.tf32_agreement's border, t
   within rtol 1e-5 plus the bound of a reordered sum) and at one block
   against Möller (the script's bar:
   99.95% of pairs, t within rtol 1e-2), with times, bounds and the
   yardstick torch.matmul of the Plücker products.

Every launch count is set to 0 just before a path is driven and read
just after; a kernel of the path that never launched fails the run. Any
failed phase exits non-zero. The last line is the result object, the
line before it the per-kernel record. Needs no network and one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H, BOUNCES = 1920, 1080, 3
N_CLUSTERS = 2048
N_LIGHTS = 1024  # bench.py's deferred stage: 1024 scattered point lights
WARMUP, TIMED = 2, 8
PLAIN_FRAME_BUDGET_S = 120.0
SOURCES = {
    "trace_bvh": "prosper_tpu_torch/csrc/trace_bvh.cu",
    "shade_tiles": "prosper_tpu_torch/csrc/shade_tiles.cu",
    "trace_flat": "prosper_tpu_torch/csrc/trace_flat.cu",
    "trace_leafmajor": "prosper_tpu_torch/csrc/trace_leafmajor.cu",
    "trace_wavefront": "prosper_tpu_torch/csrc/trace_wavefront.cu",
    "bench_kernels": "prosper_tpu_torch/csrc/bench_kernels.cu",
}
# kernel -> (source, the Pallas kernel it replaces)
KERNELS = {
    "trace_primary_bvh_full": ("trace_bvh",
                               "prosper_tpu/ops/trace_bvh.py:1431"),
    "trace_closest_bvh": ("trace_bvh", "prosper_tpu/ops/trace_bvh.py:1050"),
    "trace_any_bvh": ("trace_bvh", "prosper_tpu/ops/trace_bvh.py:1768"),
    "trace_closest_bvh_full": ("trace_bvh",
                               "prosper_tpu/ops/trace_bvh.py:1211"),
    "shade_clustered_tiles": ("shade_tiles",
                              "prosper_tpu/ops/shade_tiles.py:351"),
    "trace_closest_flat": ("trace_flat",
                           "prosper_tpu/ops/trace_pallas.py:272"),
    "trace_closest_flat_full": ("trace_flat",
                                "prosper_tpu/ops/trace_pallas_full.py:255"),
    "trace_any_flat": ("trace_flat", "prosper_tpu/ops/trace_pallas.py:396"),
    "trace_any_bvh_dense": ("trace_bvh",
                            "prosper_tpu/ops/trace_bvh.py:1809"),
    "trace_closest_bvh_dense": ("trace_bvh",
                                "prosper_tpu/ops/trace_bvh.py:1144"),
    "run_pairs": ("trace_leafmajor",
                  "prosper_tpu/ops/trace_leafmajor.py:397"),
    "trace_closest_bvh8": ("trace_bvh", "prosper_tpu/ops/trace_bvh.py:1918"),
    "trace_closest_bvh8_full": ("trace_bvh",
                                "prosper_tpu/ops/trace_bvh.py:1948"),
    "trace_any_bvh8": ("trace_bvh", "prosper_tpu/ops/trace_bvh.py:1977"),
    "walk_leaves": ("trace_wavefront", "experiments/trace_wavefront.py:158"),
    "trace_closest_bvh_visits": ("trace_bvh",
                                 "scripts/bench_visit_breakdown.py:148"),
    "isect_loop_moller": ("bench_kernels",
                          "experiments/bench_mxu_isect.py:130"),
    "isect_loop_plucker": ("bench_kernels",
                           "experiments/bench_mxu_isect.py:130"),
    "isect_loop_plucker_pre": ("bench_kernels",
                               "experiments/bench_mxu_isect.py:130"),
    "moller_chain_loop": ("bench_kernels",
                          "scripts/bench_visit_breakdown.py:179"),
    "loop_flat": ("bench_kernels", "scripts/bench_loop_overhead.py:58"),
    "loop_nested": ("bench_kernels", "scripts/bench_loop_overhead.py:88"),
    "loop_cond": ("bench_kernels", "scripts/bench_loop_overhead.py:113"),
    "loop_vec": ("bench_kernels", "scripts/bench_loop_overhead.py:143"),
}
# phase 15: the kernels the measurement entry points run
EXPERIMENT_PATH = ("walk_leaves", "trace_closest_bvh_visits",
                   "isect_loop_moller", "isect_loop_plucker",
                   "isect_loop_plucker_pre", "moller_chain_loop", "loop_flat",
                   "loop_nested", "loop_cond", "loop_vec")
PT_PATH = ("trace_primary_bvh_full", "trace_closest_bvh", "trace_any_bvh")
# the kernels whose ptxas line phase 2 prints: K2, K3, K1 and K4 on the
# warp walk, then X3a on the one-thread walk
PTXAS_KERNELS = ("warp_closest_kernel", "warp_any_kernel", "primary_kernel",
                 "closest_full_kernel", "closest_kernel")
DEFERRED_PATH = {False: ("trace_primary_bvh_full", "shade_clustered_tiles"),
                 True: ("trace_closest_bvh_full", "shade_clustered_tiles")}
# the blend and mask plates; with them entry() sets the CLI's flags:
# use_transparent and two alpha-discard rounds
ALPHA = {"blend_every": 8, "mask_every": 8}
# label -> (entry options, the kernels the frame runs)
FORWARD_CELLS = {
    "forward opaque": ({"mode": "forward"},
                       ("trace_closest_bvh", "shade_clustered_tiles")),
    "forward blend/mask": ({"mode": "forward", **ALPHA},
                           ("trace_closest_flat", "trace_closest_bvh_full",
                            "shade_clustered_tiles")),
    "deferred culled blend/mask bvh=False": (
        {"mode": "deferred", "use_culling": True, "bvh": False, **ALPHA},
        ("trace_closest_flat_full", "shade_clustered_tiles")),
}
# label -> (entry options, config.policy.any_tracer, the kernels the
# frame runs)
RESTIR_CELLS = {
    "restir bvh stack": ({}, "stack",
                         ("trace_primary_bvh_full", "trace_any_bvh")),
    "restir bvh dense": ({}, "dense",
                         ("trace_primary_bvh_full", "trace_any_bvh_dense")),
    "restir bvh=False": ({"bvh": False}, "stack",
                         ("trace_closest_flat_full", "trace_any_flat")),
}
PT_FLAT_PATH = ("trace_closest_flat_full", "trace_any_flat")
# label -> (entry options, the kernels the frame runs) under
# config.policy.bounce_tracer = "leafmajor"
LEAFMAJOR_CELLS = {
    "pt leafmajor": ({"max_bounces": BOUNCES},
                     ("trace_primary_bvh_full", "run_pairs",
                      "trace_closest_bvh", "trace_any_bvh")),
    "restir leafmajor": ({"mode": "restir", "scatter_lights": N_LIGHTS},
                         ("trace_primary_bvh_full", "run_pairs",
                          "trace_any_bvh")),
}
PORT_KERNEL_SYMBOLS = ("primary_kernel", "warp_closest_kernel",
                       "warp_any_kernel", "closest_kernel",
                       "closest_full_kernel", "shade_kernel", "flat_kernel",
                       "flat_any_kernel", "dense_any_kernel",
                       "dense_closest_kernel", "pairs_kernel",
                       "closest8_kernel", "closest8_full_kernel",
                       "any8_kernel", "walk_kernel", "isect_loop_kernel",
                       "loop_flat_kernel", "loop_nested_kernel",
                       "loop_cond_kernel", "loop_vec_kernel")
# the glTF World scene: plate-2048's plates, the last 64 as instances
WORLD_INSTANCED = 64
# trace kernel vs plain: hit/miss and occlusion equal; tri equal unless
# the two t agree within 1e-6 relative (an exact tie); t within rtol 1e-5
# / atol 1e-6; interpolated attributes (and u, v) within 1e-4
T_RTOL, T_ATOL, TIE_RTOL, ATTR_TOL = 1e-5, 1e-6, 1e-6, 1e-4
# shading kernel vs plain: every channel within rtol 1e-5 / atol 1e-6.
# Both evaluate the same float32 operations in the same order (the
# kernel is built with --fmad=false) over the same ascending light list,
# so they differ only where logf/expf/sqrtf and PyTorch's log/exp/sqrt
# round differently, by an ulp, and a sum of up to 128 + 128 lights
# carries that to a few ulps.
K5_RTOL, K5_ATOL = 1e-5, 1e-6

# The bound: the larger of the bytes the function must move (each input
# read once, each output written once) over the H100's 3.35 TB/s, and
# its float32 operations over the 67 TFLOP/s outside the tensor cores
# (NVIDIA's data sheet, SXM, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations, counted in the CUDA sources: one ray-triangle test
# (csrc/trace_bvh.cu moller: the two cross products, three dot products,
# the reciprocal and the six range tests); per point light of a pixel's
# list up to its 128th visible one, the z-slab test and the running
# count (later tests cannot change the color); one shaded point light
# (attenuation, light_contrib, accumulation); one spot light.
MOLLER_OPS = 53
LANES = 128  # triangles per cluster slab
# Phase 15. One slab test (csrc/ray_common.cuh slab_enter: 6 subtractions,
# 6 products, 6 min/max, 3 max for the entry, 2 min for the exit, 2
# compares). The Plücker block per (ray, triangle): its products at their
# real depth, 2 x (6 + 6 + 3 + 3), on the tensor cores at the H100's 495
# TF32 TFLOP/s, and its epilogue (csrc/bench_kernels.cu: abs, compare,
# reciprocal, select, t, u, v, five range tests, u + v, select, min) at
# 67 TFLOP/s. A one-block loop is held to one of the 132 SMs' share.
SLAB_OPS = 25
TF32_OPS_PER_S = 495e12
PLUCKER_PRODUCT_OPS = 36
PLUCKER_EPILOGUE_OPS = 17
H100_SMS = 132
TILE_RAYS = 256
# The loop probes' bound: the cycles of one iteration's loop-carried
# dependence chain at the SM clock, the chain read from the sm_90a SASS
# of csrc/bench_kernels.cu (cuobjdump -sass), with assumed latencies in
# cycles: 4 for a dependent integer or float32 add, multiply or min, 23
# for a warp shuffle and for a shared-memory load, 20 for a
# shared-memory store and for a block barrier. nvcc unrolls flat and
# nested 16 times and carries the sum through eight three-input adds
# (IADD3) per 16 iterations; cond's else branch folds into one IADD3 of
# s[i] + 3 per four iterations; vec carries sub, mul, min, five shuffle
# and min steps, the store, the barrier, a load, seven mins and the add.
LAT_ALU, LAT_SHFL, LAT_LDS, LAT_STS, LAT_BAR = 4, 23, 23, 20, 20
PROBE_CHAIN_CYCLES = {
    "loop_flat": 8 * LAT_ALU / 16, "loop_nested": 8 * LAT_ALU / 16,
    "loop_cond": LAT_ALU / 4,
    "loop_vec": (3 * LAT_ALU + 5 * (LAT_SHFL + LAT_ALU) + LAT_STS + LAT_BAR
                 + LAT_LDS + 7 * LAT_ALU + LAT_ALU),
}
LIST_LIGHT_OPS = 6
POINT_LIGHT_OPS = 109
SPOT_LIGHT_OPS = 112


def ptxas_line(log: str, symbol: str) -> str:
    """The compiler's report (ptxas -v) of the kernel `symbol`:
    registers, stack frame and spills, from the block of the entry
    function whose mangled name holds <length><symbol>."""
    key = f"{len(symbol)}{symbol}"
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        if key not in mangled:
            continue
        lines = block.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if ln.rstrip().endswith(f"Function properties for {mangled}"))
        used = next(ln for ln in lines if ": Used " in ln)
        return (f"{symbol}: {used.split(': ', 1)[1].strip()}; "
                f"{lines[at + 1].strip()}")
    raise RuntimeError(f"no ptxas report for {symbol}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


def elapsed_ms(fn) -> float:
    """Time of one fn() call, with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def device_ms(fn, reps: int) -> float:
    """Mean time of fn() over reps calls, after one warm-up call."""
    fn()

    def loop():
        for _ in range(reps):
            fn()

    return elapsed_ms(loop) / reps


def timed_call(fn):
    """(output, ms) of one fn() call after one warm-up call."""
    fn()
    out = []
    ms = elapsed_ms(lambda: out.append(fn()))
    return out[0], ms


@contextlib.contextmanager
def patched(*swaps):
    """Swap attributes of modules, (module, name, replacement) each, for
    the duration of a with block."""
    with contextlib.ExitStack() as stack:
        for module, name, value in swaps:
            stack.enter_context(mock.patch.object(module, name, value))
        yield


def all_kernels():
    from prosper_tpu_torch.experiments import trace_wavefront as tw
    from prosper_tpu_torch.ops import bench_kernels as bk
    from prosper_tpu_torch.ops import shade_tiles as tst
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.ops import trace_flat as tf
    from prosper_tpu_torch.ops import trace_leafmajor as lm

    return (tb.KERNELS + tst.KERNELS + tf.KERNELS + lm.KERNELS + tw.KERNELS
            + bk.KERNELS)


def reset_counts() -> None:
    for f in all_kernels():
        f.launches = 0


def read_counts() -> dict:
    return {f.__name__: f.launches for f in all_kernels()}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time on an H100 for moving n_bytes and doing n_ops."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def leaf_boxes(scene):
    """The cluster AABBs of the BVH's leaves, (C, 3) x 2."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    return tb._leaf_boxes(scene["frame"]["bvh_bounds"],
                          scene["frame"]["bvh_meta"],
                          scene["geom"]["packed_full"].shape[0])


def entered_pairs(boxes, o, d, t_lim, live=None) -> int:
    """(ray, cluster) pairs whose AABB (boxes = (cmin, cmax)) the ray
    enters before t_lim, with the plain versions' slab test; live (C,)
    drops masked clusters. Inverted (masked) boxes never count."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    cmin, cmax = boxes
    valid = ~(cmin > cmax).any(dim=-1)
    live = valid if live is None else live & valid
    inv = tb.safe_inv_dir(d)
    n = 0
    for r0 in range(0, o.shape[0], 16384):
        r1 = min(o.shape[0], r0 + 16384)
        enter, exit_ = tb.slab_enter_exit(o[r0:r1, None], inv[r0:r1, None],
                                          cmin[None], cmax[None])
        ok = (enter <= exit_) & (enter < t_lim[r0:r1, None]) & live[None, :]
        n += int(ok.sum())
    return n


def closest_ops(boxes, o, d, rows, t_max, live=None) -> int:
    """Möller tests the closest hit needs: all 128 triangles of every
    cluster whose AABB the ray enters before its final hit t."""
    t_lim = torch.where(rows[:, 1] >= 0, rows[:, 0], t_max)
    return MOLLER_OPS * 128 * entered_pairs(boxes, o, d, t_lim, live)


def compare_rows(got, want, attr_cols):
    """Kernel vs plain hit rows ((R, 8) or (R, 16)) -> (ok, mismatch
    counts, max abs error over t and attr_cols where both hit)."""
    g_hit, w_hit = got[:, 1] >= 0, want[:, 1] >= 0
    both = g_hit & w_hit
    dt = torch.abs(got[:, 0] - want[:, 0])
    scale = torch.abs(want[:, 0])
    tie = dt <= TIE_RTOL * scale
    same_tri = got[:, 1] == want[:, 1]
    attr = torch.where(
        (both & same_tri)[:, None],
        (got[:, attr_cols] - want[:, attr_cols]).abs(), 0.0,
    )
    counts = {
        "rays": int(got.shape[0]),
        "hits": int(w_hit.sum()),
        "hit_mismatch": int((g_hit != w_hit).sum()),
        "tri_mismatch": int((both & ~same_tri & ~tie).sum()),
        "tri_ties": int((both & ~same_tri & tie).sum()),
        "t_out_of_tol": int((both & (dt > T_ATOL + T_RTOL * scale)).sum()),
        "attr_out_of_tol": int((attr > ATTR_TOL).any(dim=1).sum()),
    }
    ok = all(counts[k] == 0 for k in (
        "hit_mismatch", "tri_mismatch", "t_out_of_tol", "attr_out_of_tol"))
    err = max(float(torch.where(both, dt, 0.0).amax()), float(attr.amax()))
    return ok, counts, err


def capture_wavefronts(pt, fn, scene, cam):
    """Run one frame; keep the first shadow set and the first bounce set
    as the path tracer hands them to the kernels."""
    captured = {}

    def rec(slabs, bounds, meta, o, d, t_min, t_max):
        captured.setdefault(
            "closest", (slabs, o.clone(), d.clone(), t_min, t_max.clone()))
        return real(slabs, bounds, meta, o, d, t_min, t_max)

    real = pt.trace_closest_bvh
    with recording_tracer(pt, 1) as any_calls, patched(
            (pt, "trace_closest_bvh", rec)):
        fn(scene, cam, 0)
    torch.cuda.synchronize()
    slabs, _, _, o, d, t_min, t_max = any_calls[0][1]
    captured["any"] = (slabs, o, d, t_min, t_max)
    return captured


def walk_twins(label, slabs, bvh, rays, got, mask=None):
    """K1's or K4's rows `got` against the one-thread walk on the same
    rays (o, d, t_min, t_max), bit for bit: without a mask X3a's rows 0-3
    through the attribute interpolation (_full_rows), with one the
    lockstep plain walk's under the same mask. Returns the record: rows
    equal, and without a mask X3a's ms on the same rays (with one X3a
    would test the leaves the mask drops, so its time is not kept)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    o, d, t_min, t_max = rays
    args = (slabs, *bvh, o, d, t_min, t_max)
    if mask is not None:
        walk = tb.trace_closest_bvh_visits_plain(*args, skip_mask=mask)
        eq = torch.equal(got, tb._full_rows(slabs, walk))
        print(f"{label} vs the masked lockstep plain walk on the same "
              f"rays: rows equal {eq}")
        return {"walk_rows_equal": eq}
    walk = tb.trace_closest_bvh_visits(*args)
    tb.check_stack_overflow(o.device)
    eq = torch.equal(got, tb._full_rows(slabs, walk))
    x3a_ms = device_ms(lambda: tb.trace_closest_bvh_visits(*args), 5)
    print(f"{label} vs X3a on the same rays: rows equal {eq}; X3a "
          f"{x3a_ms:.3f} ms")
    return {"walk_rows_equal": eq, "x3a_same_rays_ms": x3a_ms}


def check_primary(label, scene, cols, cam_vec, frame_index, t_min):
    """K1 against its plain version on every lane of `cols`."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    geom, frame = scene["geom"], scene["frame"]
    dev = geom["packed_full"].device
    args = (geom["packed_full"], frame["bvh_bounds"], frame["bvh_meta"],
            cols, cam_vec, frame_index, t_min)
    want, plain_ms = timed_call(lambda: tb.trace_primary_bvh_full_plain(*args))
    got = tb.trace_primary_bvh_full(*args)
    tb.check_stack_overflow(dev)
    ok, counts, err = compare_rows(got, want, list(range(2, 13)))
    print(f"K1 {label}: ok={ok} {counts}")
    o, d, tmax = tb.raygen_plain(cols, cam_vec, frame_index)
    o = o.contiguous()
    ms = device_ms(lambda: tb.trace_primary_bvh_full(*args), 5)
    twins = walk_twins(f"K1 {label} ({ms:.3f} ms)", args[0], args[1:3],
                       (o, d, t_min, tmax), got)
    ok &= twins["walk_rows_equal"]
    rec = {"max_abs_err": err, "rays": int(got.shape[0]), "ms": ms,
           "plain_ms": plain_ms, **twins,
           **bound(nbytes(*args[:5], got),
                   closest_ops(leaf_boxes(scene), o, d, want, tmax))}
    return ok, rec, want


def check_pt_kernels(label, fn, scene, cam, width, height):
    """The path tracer's kernels against their plain versions on the
    whole wavefront the frame gives each (K1 every pixel, K2 the first
    bounce set, K3 the first shadow set), with both times and the
    bounds; K2 also against X3a's rows 0-5, bit for bit, with its time.
    Returns (ok, per-kernel records, primary coverage)."""
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.render import pt

    frame = scene["frame"]
    dev = scene["geom"]["packed_full"].device
    bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]
    _, _, cols, _ = pt._pixel_layouts(width, height, str(dev))
    cam_vec = tb.primary_cam_vec(cam, width, height, device=dev)
    ok_all, rec, want = check_primary(f"{label} (path tracer form)", scene,
                                      cols, cam_vec, 0, pt.BOUNCE_T_MIN)
    records = {"trace_primary_bvh_full": rec}
    cover = float((want[: width * height, 1] >= 0).float().mean())
    print(f"primary_coverage={cover:.4f}")

    captured = capture_wavefronts(pt, fn, scene, cam)
    for key, tag in (("closest", "K2"), ("any", "K3")):
        slabs, o, d, t_min, t_max = captured[key]
        args = (slabs, bounds, meta, o, d, t_min, t_max)
        live = int((t_max > 0).sum())
        if key == "closest":
            kern, plain = tb.trace_closest_bvh, tb.trace_closest_bvh_plain
        else:
            kern, plain = tb.trace_any_bvh, tb.trace_any_bvh_plain
        want, plain_ms = timed_call(lambda: plain(*args))
        got = kern(*args)
        tb.check_stack_overflow(dev)
        ms = device_ms(lambda: kern(*args), 5)
        extra = {}
        if key == "closest":
            ok, counts, err = compare_rows(got, want, [2, 3])
            ops = closest_ops(leaf_boxes(scene), o, d, want, t_max)
            # the one-thread walk (X3a, K2's old design) on the same rays:
            # rows 0-5 equal bit for bit, tri on exact ties included
            x3a = tb.trace_closest_bvh_visits(*args)
            tb.check_stack_overflow(dev)
            same = torch.equal(got[:, 0:6], x3a[:, 0:6])
            ok &= same
            extra["x3a_rows_equal"] = same
            extra["x3a_same_rays_ms"] = device_ms(
                lambda: tb.trace_closest_bvh_visits(*args), 5)
            print(f"K2 {label} vs X3a (the one-thread walk) on the same "
                  f"rays: rows 0-5 equal {same}; K2 {ms:.3f} ms, X3a "
                  f"{extra['x3a_same_rays_ms']:.3f} ms")
        else:
            mism = int((got != want).sum())
            ok = mism == 0
            err = float((got.float() - want.float()).abs().max())
            counts = {"rays": int(got.shape[0]), "occluded": int(want.sum()),
                      "occlusion_mismatch": mism}
            extra["occlusion_mismatch"] = mism
            # an occluded ray needs one cluster's tests at least; a free
            # one every cluster it enters before t_max
            free = ~want
            ops = MOLLER_OPS * 128 * (int(want.sum()) + entered_pairs(
                leaf_boxes(scene), o[free], d[free], t_max[free]))
        print(f"{tag} {label}: ok={ok} {live} live rays; {counts}")
        ok_all &= ok
        records[kern.__name__] = {
            "max_abs_err": err, **extra, "rays": int(got.shape[0]),
            "live_rays": live, "ms": ms, "plain_ms": plain_ms,
            **bound(nbytes(*args, got), ops),
        }
    tb.check_stack_overflow(dev)
    return ok_all, records, cover


def frames_agree(label, a, b):
    """Two frames' (image, stat): equal stats (ray counts or drawn
    meshlets) and at most 1% of pixels off by more than 1e-3."""
    (img_a, n_a), (img_b, n_b) = a, b
    diff = (img_a.cpu() - img_b.cpu()).abs()
    off = float((diff > 1e-3).any(dim=-1).float().mean())
    print(f"{label}: stat {int(n_a)} vs {int(n_b)}, max abs diff "
          f"{float(diff.max()):.3e}, share of pixels off by > 1e-3 {off:.5f}")
    if int(n_a) != int(n_b) or off > 0.01:
        raise RuntimeError(f"{label}: the frames disagree")


def breakdown(fn, scene, cam, frame_index, state=None, top=12):
    """One frame under torch.profiler: device time by kernel, the port's
    CUDA kernels' share, and the device's idle share of the frame's wall
    time (profiling adds host overhead, so the idle share is an upper
    bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = elapsed_ms(lambda: fn(scene, cam, frame_index, state))
    rows = sorted(
        ((e.key, e.device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows
               if any(k in r[0] for k in PORT_KERNEL_SYMBOLS))
    print(f"profile of one frame: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {max(0.0, 1 - busy / wall):.3f}), "
          f"port kernels {ours:.3f} ms, other kernels {busy - ours:.3f} ms "
          f"in {sum(r[2] for r in rows)} launches")
    for name, ms, count in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x {name[:90]}")


def drive(fn, scene, cam, path, label, smi):
    """The main path of one mode: counts to 0, 2 warm-up + 8 timed
    frames, counts read. Returns (ms/frame, launches, last image, last
    state, per-frame stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = None
    for i in range(WARMUP):
        img, state, _ = fn(scene, cam, i, state)
    out, stats = [img, state], []

    def frames():
        for i in range(WARMUP, WARMUP + TIMED):
            out[0], out[1], stat = fn(scene, cam, i, out[1])
            stats.append(stat)

    ms_frame = elapsed_ms(frames) / TIMED
    launches = read_counts()
    img = out[0]
    print(f"{label}: ms/frame {ms_frame:.3f}; launches {launches} over "
          f"{WARMUP + TIMED} frames")
    print(f"{label}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes; card: {smi}")
    finite = bool(torch.isfinite(img).all())
    print(f"{label}: image {tuple(img.shape)} finite={finite} "
          f"mean={float(img.mean()):.5f}")
    if not (finite and bool((img > 0).any()) and tuple(img.shape) == (H, W, 3)):
        raise RuntimeError(f"{label}: the image is not finite and non-zero")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{label}: kernels of the path never launched: "
                           f"{missing}")
    return ms_frame, {k: launches[k] for k in path}, img, out[1], stats


def run_pt(smi, dev):
    """Phase 3 for K1-K3 and phase 4; returns (records, launches)."""
    from prosper_tpu_torch import entry as port_entry
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.render import pt

    phase("kernels: path tracer")
    fn64, (scene64, cam64, _) = port_entry.entry(
        dev, scene="test", n_clusters=4, width=64, height=64, max_bounces=2
    )
    ok64, _, _ = check_pt_kernels("test 64x64", fn64, scene64, cam64, 64, 64)
    fn, (scene, cam, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        max_bounces=BOUNCES,
    )
    C = scene["geom"]["packed_full"].shape[0]
    print(f"plate scene: {C} clusters, {C * 128} triangles, "
          f"{scene['frame']['bvh_bounds'].shape[0]} BVH nodes")
    ok, records, cover = check_pt_kernels(f"plate {W}x{H}", fn, scene, cam,
                                          W, H)
    print("kernel, plain and bound times on the whole wavefronts: " + ", ".join(
        f"{k} {r['ms']:.3f} vs {r['plain_ms']:.1f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
        for k, r in records.items()) + f"; card: {smi}")
    if not (ok and ok64):
        raise RuntimeError("a kernel disagrees with its plain version")

    phase("pt")
    ms_frame, launches, img, state, rays = drive(
        fn, scene, cam, PT_PATH, f"pt {W}x{H} bounces={BOUNCES}", smi)
    rays_frame = sum(int(r) for r in rays) / TIMED
    print(f"pt frame {W}x{H} bounces={BOUNCES}: ms/frame {ms_frame:.3f} "
          f"rays/frame {rays_frame:.0f} Mrays/s "
          f"{rays_frame / ms_frame / 1e3:.3f} primary_coverage {cover:.4f} "
          f"accumulated_samples={float(state[1][0, 0]):.0f}")
    breakdown(fn, scene, cam, WARMUP + TIMED)

    # the frame on the card against the CPU frame (plain versions)
    fn_c, (scene_c, cam_c, _) = port_entry.entry(
        "cpu", scene="test", n_clusters=4, width=64, height=64, max_bounces=2
    )
    img_d, _, n_d = fn64(scene64, cam64, 3)
    img_c, _, n_c = fn_c(scene_c, cam_c, 3)
    frames_agree("pt test 64x64 frame cuda vs cpu", (img_d, n_d),
                 (img_c, n_c))

    # the same 1080p frame with the three plain versions on the card,
    # against the kernels' frame of the same index
    k1, k2, k3 = (records[k] for k in PT_PATH)
    est_s = 1e-3 * (k1["plain_ms"] + (BOUNCES - 1) * k2["plain_ms"]
                    + BOUNCES * k3["plain_ms"])
    if est_s < PLAIN_FRAME_BUDGET_S:
        plain = []
        with patched(
            (pt, "trace_primary_bvh_full", tb.trace_primary_bvh_full_plain),
            (pt, "trace_closest_bvh", tb.trace_closest_bvh_plain),
            (tb, "trace_any_bvh", as_plain(tb.trace_any_bvh_plain)),
        ):
            plain_frame_ms = elapsed_ms(
                lambda: plain.append(fn(scene, cam, WARMUP)))
        print(f"pt frame with the plain versions: ms/frame "
              f"{plain_frame_ms:.1f} (with the kernels {ms_frame:.3f}); "
              f"card: {smi}")
        img_k, _, n_k = fn(scene, cam, WARMUP)
        frames_agree(f"pt {W}x{H} frame {WARMUP} kernels vs plain versions",
                     (img_k, n_k), (plain[0][0], plain[0][2]))
    else:
        print(f"pt frame with the plain versions: skipped (estimated "
              f"{est_s:.0f} s > {PLAIN_FRAME_BUDGET_S:.0f} s)")
    return records, launches


def as_plain(plain):
    """A trace kernel's plain version behind its wrapper's signature
    (..., o, d, t_min, t_max scalar or per ray, keyword options)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    def fn(*args, **kw):
        *head, o, d, t_min, t_max = args
        return plain(*head, o, d, float(t_min),
                     tb.as_tmax(t_max, o.shape[0], o.device), **kw)
    return fn


def plain_paths():
    """The deferred, forward, ReSTIR and path tracer frames' kernels
    swapped for their plain versions, wherever the frames look them up
    (render/pt.py and render/gbuffer.py import some wrappers by name;
    ops/trace.make_tracer reads the wrappers of ops/trace_bvh.py and
    ops/trace_flat.py at each call, the leaf-major hybrid those of
    ops/trace_leafmajor.py and ops/trace_bvh.py)."""
    from prosper_tpu_torch.ops import shade_tiles as tst
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.ops import trace_flat as tf
    from prosper_tpu_torch.ops import trace_leafmajor as lm
    from prosper_tpu_torch.render import gbuffer, pt, shading

    return patched(
        (gbuffer, "trace_primary_bvh_full", tb.trace_primary_bvh_full_plain),
        (pt, "trace_primary_bvh_full", tb.trace_primary_bvh_full_plain),
        (pt, "trace_closest_bvh", as_plain(tb.trace_closest_bvh_plain)),
        (lm, "run_pairs", lm.run_pairs_plain),
        (gbuffer, "trace_closest_bvh_full",
         as_plain(tb.trace_closest_bvh_full_plain)),
        (gbuffer, "trace_closest_flat_full",
         as_plain(tf.trace_closest_flat_full_plain)),
        (pt, "trace_closest_flat_full",
         as_plain(tf.trace_closest_flat_full_plain)),
        (tb, "trace_closest_bvh", as_plain(tb.trace_closest_bvh_plain)),
        (tf, "trace_closest_flat", as_plain(tf.trace_closest_flat_plain)),
        (tb, "trace_any_bvh", as_plain(tb.trace_any_bvh_plain)),
        (tb, "trace_any_bvh_dense", as_plain(tb.trace_any_bvh_dense_plain)),
        (tf, "trace_any_flat", as_plain(tf.trace_any_flat_plain)),
        (shading, "shade_clustered_tiles", tst.shade_clustered_tiles_plain),
    )


@contextlib.contextmanager
def recording(module, name):
    """Keep (args, kwargs) of every call of module.name made inside the
    with block, uncopied: the G-buffer, transparent and shading code
    recorded here never change their rays, masks or inputs in place."""
    real = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(module, name, rec):
        yield calls


def culled_phases(run):
    """Call run() with K4 recorded -> (its result, the inputs of each
    culling phase as (o, d, t_min, t_max, skip_mask))."""
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.render import gbuffer

    with recording(gbuffer, "trace_closest_bvh_full") as calls:
        out = run()
    if len(calls) != 2:
        raise RuntimeError(f"a culled frame traced {len(calls)} phases, not 2")
    return out, [(o, d, t_min, tb.as_tmax(t_max, o.shape[0], o.device),
                  kw["skip_mask"])
                 for (_, _, _, o, d, t_min, t_max), kw in calls]


def check_k4_phases(label, scene, seen):
    """K4 against its plain version on each culling phase's rays and
    mask -> (ok, record over both phases)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    geom, frame = scene["geom"], scene["frame"]
    dev = geom["packed_full"].device
    ok_all = True
    k4 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "rays": 0,
          "bound_bytes": 0, "bound_ops": 0, "live_clusters": [],
          "walk_rows_equal": True, "phase_ms": []}
    for i, (o, d, t_min, t_max, mask) in enumerate(seen, 1):
        args = (geom["packed_full"], frame["bvh_bounds"], frame["bvh_meta"],
                o, d, t_min, t_max)
        want, plain_ms = timed_call(
            lambda: tb.trace_closest_bvh_full_plain(*args, skip_mask=mask))
        got = tb.trace_closest_bvh_full(*args, skip_mask=mask)
        tb.check_stack_overflow(dev)
        ok, counts, err = compare_rows(got, want, list(range(2, 13)))
        print(f"K4 {label}, phase {i}: ok={ok} live clusters "
              f"{int(mask.sum())} of {mask.shape[0]}; {counts}")
        b = bound(nbytes(*args, mask, got),
                  closest_ops(leaf_boxes(scene), o, d, want, t_max, mask))
        ms = device_ms(
            lambda: tb.trace_closest_bvh_full(*args, skip_mask=mask), 5)
        twins = walk_twins(
            f"K4 {label}, phase {i} ({ms:.3f} ms, bound "
            f"{b['bound_ms']:.3f})", args[0], args[1:3],
            (o, d, t_min, t_max), got, mask)
        ok &= twins["walk_rows_equal"]
        ok_all &= ok
        k4["walk_rows_equal"] &= twins["walk_rows_equal"]
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        k4["ms"] += ms
        k4["phase_ms"].append(ms)
        k4["plain_ms"] += plain_ms
        k4["rays"] += int(got.shape[0])
        k4["bound_bytes"] += b["bound_bytes"]
        k4["bound_ops"] += b["bound_ops"]
        k4["live_clusters"].append(int(mask.sum()))
    k4.update(bound(k4.pop("bound_bytes"), k4.pop("bound_ops")))
    return ok_all, k4


def check_deferred_kernels(fns, scene, cam):
    """Phase 3 for the deferred path: K1 in its G-buffer form on every
    pixel; K4 on both culling phases of frame 1 (culled against frame
    0's HiZ), and on both phases of a G-buffer culled against an
    all-near previous HiZ, which must equal the unculled G-buffer; K5 on
    an unculled frame's G-buffer. Returns (ok, records)."""
    from prosper_tpu_torch.ops import hiz
    from prosper_tpu_torch.ops import shade_tiles as tst
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.render import gbuffer, shading

    dev = scene["geom"]["packed_full"].device
    cols = gbuffer._row_pixels(W, H, str(dev))
    cam_vec = tb.primary_cam_vec(cam, W, H, pixel_jitter=cam["current_jitter"],
                                 device=dev)
    ok_all, k1, _ = check_primary(f"plate {W}x{H} (G-buffer form)", scene,
                                  cols, cam_vec, 0, gbuffer.GBUFFER_T_MIN)
    records = {"trace_primary_bvh_full": k1}

    # K4: both phases of a culled frame of the main path
    _, state, _ = fns[True](scene, cam, 0)
    _, seen = culled_phases(lambda: fns[True](scene, cam, 1, state))
    ok, k4 = check_k4_phases("frame 1", scene, seen)
    ok_all &= ok

    # the occlusion half: an all-near previous HiZ (tests/test_two_phase.py's
    # adversarial case) hides every cluster in phase 1, so phase 2 traces
    # the clusters that the fresh HiZ frees, and the min-t merge decides
    near = hiz.build_hiz(torch.full((H, W), 0.999, device=dev), W, H)
    culled, seen = culled_phases(lambda: gbuffer.render_gbuffer(
        scene, cam, W, H, use_culling=True, prev_hiz=near))
    ok, k4_near = check_k4_phases("all-near previous HiZ", scene, seen)
    base = gbuffer.render_gbuffer(scene, cam, W, H)
    valid_eq = bool(torch.equal(base["valid"], culled["valid"]))
    depth_err = float((base["depth"] - culled["depth"]).abs().max())
    live2 = k4_near["live_clusters"][1]
    print(f"G-buffer culled against the all-near HiZ vs unculled: valid "
          f"equal {valid_eq}, max depth diff {depth_err:.3e}, phase-2 live "
          f"clusters {live2}")
    if live2 == 0:
        raise RuntimeError("the all-near HiZ left phase 2 nothing to trace")
    ok_all &= ok and valid_eq and depth_err <= 1e-6
    k4["max_abs_err"] = max(k4["max_abs_err"], k4_near["max_abs_err"])
    k4["near_hiz_live_clusters"] = k4_near["live_clusters"]
    records["trace_closest_bvh_full"] = k4

    # K5 on the frame's G-buffer
    with recording(shading, "shade_clustered_tiles") as calls:
        fns[False](scene, cam, 0)
    (inp, _, _), _ = calls[0]
    (want, cnt, needed), plain_ms = timed_call(
        lambda: tst.shade_clustered_tiles_plain(inp, W, H, return_counts=True))
    got = tst.shade_clustered_tiles(inp, W, H)
    diff = (got - want).abs()
    out_of_tol = int((diff > K5_ATOL + K5_RTOL * want.abs()).sum())
    valid = inp["chan"][12] > 0
    # the z-slab tests the color needs: up to each pixel's 128th visible
    # light (the kernel may walk on; that is not counted)
    listed = int(needed[valid].long().sum())
    shaded = int(torch.clamp_max(cnt, tst.MAX_FROXEL_LIGHTS)[valid].sum())
    spots = int(inp["ints"][1]) * int(valid.sum())
    ops = (LIST_LIGHT_OPS * listed + POINT_LIGHT_OPS * shaded
           + SPOT_LIGHT_OPS * spots)
    ok = out_of_tol == 0
    print(f"K5 plate {W}x{H}: ok={ok} pixels {W * H} with a surface "
          f"{int(valid.sum())}; lights per tile {int(inp['counts'].min())}-"
          f"{int(inp['counts'].max())}; needed z-slab tests {listed}, shaded "
          f"point lights {shaded}, spot evaluations {spots}; channels out of "
          f"tolerance {out_of_tol}; max abs err {float(diff.max()):.3e}")
    ok_all &= ok
    records["shade_clustered_tiles"] = {
        "max_abs_err": float(diff.max()), "pixels": W * H,
        "ms": device_ms(lambda: tst.shade_clustered_tiles(inp, W, H), 5),
        "plain_ms": plain_ms,
        **bound(nbytes(*inp.values(), got), ops),
    }
    return ok_all, records


def run_deferred(smi, dev):
    """Phase 3 for K1 (G-buffer form), K4 and K5, and phase 5; returns
    (records, launches per kernel summed over both modes)."""
    from prosper_tpu_torch import entry as port_entry
    from prosper_tpu_torch.render import gbuffer

    phase("kernels: deferred")
    fns, args = {}, None
    for cull in (False, True):
        fns[cull], args = port_entry.entry(
            dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
            mode="deferred", use_culling=cull, scatter_lights=N_LIGHTS)
    scene, cam, _ = args
    print(f"deferred scene: plate {N_CLUSTERS} clusters, "
          f"{int(scene['frame']['lights']['point_count'])} point lights")
    ok, records = check_deferred_kernels(fns, scene, cam)
    print("kernel, plain and bound times on one frame's inputs: " + ", ".join(
        f"{k} {r['ms']:.3f} vs {r['plain_ms']:.1f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
        for k, r in records.items()) + f"; card: {smi}")
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")

    phase("deferred")
    launches, results = {}, {}
    for cull in (False, True):
        label = f"deferred {W}x{H} lights={N_LIGHTS} culling={cull}"
        ms_frame, counts, img, state, drawn = drive(
            fns[cull], scene, cam, DEFERRED_PATH[cull], label, smi)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        drawn = [int(x) for x in drawn]
        print(f"{label}: drawn meshlets per timed frame {min(drawn)}-"
              f"{max(drawn)} of {N_CLUSTERS}")
        breakdown(fns[cull], scene, cam, WARMUP + TIMED, state)
        results[cull] = (ms_frame, img, state, drawn[-1])

    # culling is conservative: the culled G-buffer equals the unculled one
    base = gbuffer.render_gbuffer(scene, cam, W, H)
    culled = gbuffer.render_gbuffer(scene, cam, W, H, use_culling=True,
                                    prev_hiz=results[True][2]["hiz"])
    valid_eq = bool(torch.equal(base["valid"], culled["valid"]))
    depth_err = float((base["depth"] - culled["depth"]).abs().max())
    img_err = float((results[True][1] - results[False][1]).abs().max())
    print(f"culled vs unculled G-buffer: valid equal {valid_eq}, max depth "
          f"diff {depth_err:.3e}, max image diff {img_err:.3e}")
    if not (valid_eq and depth_err <= 1e-6):
        raise RuntimeError("the culled G-buffer differs from the unculled")

    # each 1080p frame with the plain versions against the kernels' frame
    for cull in (False, True):
        state = results[cull][2] if cull else None
        img_k, _, n_k = fns[cull](scene, cam, WARMUP, state)
        with plain_paths():
            out = []
            plain_ms = elapsed_ms(
                lambda: out.append(fns[cull](scene, cam, WARMUP, state)))
        print(f"deferred culling={cull} frame with the plain versions: "
              f"ms/frame {plain_ms:.1f} (with the kernels "
              f"{results[cull][0]:.3f}); card: {smi}")
        frames_agree(f"deferred culling={cull} {W}x{H} kernels vs plain "
                     "versions", (img_k, n_k), (out[0][0], out[0][2]))

    # 64x64 frames on the card against the CPU, two frames each
    for cull in (False, True):
        got = []
        for d in (dev, "cpu"):
            fn, (sc, cm, _) = port_entry.entry(
                d, scene="plate", n_clusters=64, width=64, height=64,
                mode="deferred", use_culling=cull, scatter_lights=100)
            _, st, _ = fn(sc, cm, 0)
            img, _, n = fn(sc, cm, 1, st)
            got.append((img, n))
        frames_agree(f"deferred culling={cull} plate-64 64x64 cuda vs cpu",
                     *got)
    return records, launches


@contextlib.contextmanager
def recording_tracer(module, which):
    """Keep (wrapper, whole arguments) of every call of the closest-hit
    (which=0) or any-hit (which=1) fns that module.make_tracer returns
    (partials of a wrapper, which counts its launches under its own
    module's name, so the wrapper stays as it is)."""
    real = module.make_tracer
    calls = []

    def make_tracer(*args, **kw):
        fns = list(real(*args, **kw))
        fn = fns[which]

        def rec(*a):
            calls.append((fn.func, fn.args + a))
            return fn(*a)
        fns[which] = rec
        return tuple(fns)

    with mock.patch.object(module, "make_tracer", make_tracer):
        yield calls


def check_flat_call(label, kern, plain, args, attr_cols):
    """One flat-kernel call (slabs, wc_min, wc_max, o, d, t_min, t_max)
    against its plain version -> (ok, record, kernel rows)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    slabs, mn, mx, o, d, t_min, t_max = args
    args = (slabs, mn, mx, o, d, float(t_min),
            tb.as_tmax(t_max, o.shape[0], o.device))
    t_max = args[-1]
    want, plain_ms = timed_call(lambda: plain(*args))
    got = kern(*args)
    ok, counts, err = compare_rows(got, want, attr_cols)
    live_rays = int((t_max > t_min).sum())
    live_clusters = int((~(mn > mx).any(dim=-1)).sum())
    print(f"{label}: ok={ok} live rays {live_rays}, live clusters "
          f"{live_clusters} of {mn.shape[0]}; {counts}")
    rec = {"max_abs_err": err, "rays": int(got.shape[0]),
           "live_rays": live_rays, "live_clusters": live_clusters,
           "ms": device_ms(lambda: kern(*args), 5), "plain_ms": plain_ms,
           **bound(nbytes(*args, got),
                   closest_ops((mn, mx), o, d, want, t_max))}
    return ok, rec, got


def check_flat_kernels(dev):
    """Phase 6: K6 on the opaque pass and first alpha retrace of a
    forward frame of the blend/mask scene, and over the unmasked AABBs
    against K2; K8 on every call of a culled deferred frame of that
    scene without BVH arrays and on its unculled G-buffer, each against
    its plain version and K4 with the same live clusters, the unculled
    one against K1 too. Returns (ok, records)."""
    from prosper_tpu_torch import entry as port_entry
    from prosper_tpu_torch.ops import trace as ttrace
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.ops import trace_flat as tf
    from prosper_tpu_torch.render import forward, gbuffer

    fn, (scene, cam, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        mode="forward", scatter_lights=N_LIGHTS, **ALPHA)
    with recording_tracer(forward, 0) as calls:
        fn(scene, cam, 0)
    torch.cuda.synchronize()
    calls = [args for _, args in calls]
    if len(calls) != 3:  # the opaque pass and two alpha retrace rounds
        raise RuntimeError(f"the forward frame made {len(calls)} K6 calls")
    ok_all, k6, _ = check_flat_call(
        f"K6 forward {W}x{H} opaque pass (blend plates masked)",
        tf.trace_closest_flat, tf.trace_closest_flat_plain, calls[0], [2, 3])
    ok, retrace, _ = check_flat_call(
        "K6 first alpha retrace", tf.trace_closest_flat,
        tf.trace_closest_flat_plain, calls[1], [2, 3])
    ok_all &= ok
    k6["max_abs_err"] = max(k6["max_abs_err"], retrace["max_abs_err"])
    k6["retrace"] = {k: retrace[k] for k in (
        "live_rays", "ms", "plain_ms", "bound_ms", "bound_by")}

    # the flat cull against the BVH walk on the same rays and clusters
    frame = scene["frame"]
    slabs, _, _, o, d, t_min, t_max = calls[0]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    flat_args = (slabs, frame["wc_aabb_min_w"], frame["wc_aabb_max_w"], o, d,
                 t_min, t_max)
    bvh_args = (slabs, *bvh, o, d, t_min, t_max)
    got = tf.trace_closest_flat(*flat_args)
    ref = tb.trace_closest_bvh(*bvh_args)
    tb.check_stack_overflow(dev)
    ok, counts, err = compare_rows(got, ref, [2, 3])
    ok_all &= ok
    k6.update(unmasked_ms=device_ms(lambda: tf.trace_closest_flat(*flat_args),
                                    5),
              k2_same_rays_ms=device_ms(
                  lambda: tb.trace_closest_bvh(*bvh_args), 5),
              vs_k2_max_abs_err=err)
    print(f"K6 over the unmasked AABBs vs K2 on the same rays: ok={ok} "
          f"{counts}; K6 {k6['unmasked_ms']:.3f} ms, K2 "
          f"{k6['k2_same_rays_ms']:.3f} ms")

    # K8: the same scene without BVH arrays, culled deferred frames
    fn_c, (scene_c, cam_c, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        mode="deferred", use_culling=True, bvh=False,
        scatter_lights=N_LIGHTS, **ALPHA)
    with recording(gbuffer, "trace_closest_flat_full") as unculled:
        gbuffer.render_gbuffer(scene_c, cam_c, W, H)
    _, state, _ = fn_c(scene_c, cam_c, 0)
    with recording(gbuffer, "trace_closest_flat_full") as culled:
        fn_c(scene_c, cam_c, 1, state)
    torch.cuda.synchronize()
    names = ("phase 1", "phase 2", "alpha retrace 1", "alpha retrace 2",
             "transparent pass")
    if len(unculled) != 1 or len(culled) != len(names):
        raise RuntimeError(f"K8 calls: {len(unculled)} unculled, "
                           f"{len(culled)} culled")
    k8, k8_rows = None, None
    attr_cols = list(range(2, 13))
    for name, (args, _) in (("unculled G-buffer", unculled[0]),
                            *zip(names, culled)):
        ok, rec, got = check_flat_call(
            f"K8 {name}", tf.trace_closest_flat_full,
            tf.trace_closest_flat_full_plain, args, attr_cols)
        ok_all &= ok
        # K4 over the same live clusters and rays
        slabs, mn, mx, o, d, t_min, t_max = args
        live = ~(mn > mx).any(dim=-1)
        ref = tb.trace_closest_bvh_full(slabs, *bvh, o, d, t_min, t_max,
                                        skip_mask=None if bool(live.all())
                                        else live)
        tb.check_stack_overflow(dev)
        ok, counts, err = compare_rows(got, ref, attr_cols)
        print(f"K8 {name} vs K4: ok={ok} {counts}")
        ok_all &= ok
        if k8 is None:
            k8, k8_rows = rec, got
            k8["calls_of_a_culled_frame"] = {}
        else:
            k8["max_abs_err"] = max(k8["max_abs_err"], rec["max_abs_err"])
            k8["calls_of_a_culled_frame"][name] = {k: rec[k] for k in (
                "live_rays", "live_clusters", "ms", "plain_ms", "bound_ms",
                "bound_by")}

    # the unculled G-buffer's K8 rows against K1's (row-major pixels)
    cols = gbuffer._row_pixels(W, H, str(dev))
    cam_vec = tb.primary_cam_vec(cam_c, W, H,
                                 pixel_jitter=cam_c["current_jitter"],
                                 device=dev)
    k1 = tb.trace_primary_bvh_full(slabs, *bvh, cols, cam_vec, 0,
                                   gbuffer.GBUFFER_T_MIN)[: W * H]
    tb.check_stack_overflow(dev)
    _, inverse = ttrace.block_order(W, H, str(dev))
    ok, counts, err = compare_rows(k8_rows[inverse], k1, attr_cols)
    print(f"K8 unculled G-buffer vs K1: ok={ok} {counts}")
    ok_all &= ok
    return ok_all, {"trace_closest_flat": k6, "trace_closest_flat_full": k8}


def plain_frame_estimate_s(label, records) -> float:
    """Seconds a 1080p frame of FORWARD_CELLS[label] would take with the
    plain versions: each kernel call at its plain time on a full frame."""
    calls = {
        "forward opaque": {"trace_closest_bvh": 1, "shade_clustered_tiles": 1},
        "forward blend/mask": {"trace_closest_flat": 3,
                               "trace_closest_bvh_full": 1,
                               "shade_clustered_tiles": 2},
        "deferred culled blend/mask bvh=False": {
            "trace_closest_flat_full": 5, "shade_clustered_tiles": 2},
    }[label]
    return 1e-3 * sum(n * records[k]["plain_ms"] for k, n in calls.items())


def run_forward(smi, dev, records):
    """Phases 6 and 7; records holds the earlier phases' kernel records
    (for the plain-frame estimates). Returns (records of K6 and K8,
    launches per kernel summed over the three frames)."""
    from prosper_tpu_torch import entry as port_entry

    phase("kernels: flat")
    ok, flat = check_flat_kernels(dev)
    print("kernel, plain and bound times on one frame's inputs: " + ", ".join(
        f"{k} {r['ms']:.3f} vs {r['plain_ms']:.1f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
        for k, r in flat.items()) + f"; card: {smi}")
    if not ok:
        raise RuntimeError("a flat kernel disagrees with its plain version "
                           "or with the BVH kernels")
    records = {**records, **flat}

    phase("forward")
    launches = {}
    for cell, (kw, path) in FORWARD_CELLS.items():
        label = f"{cell} {W}x{H} lights={N_LIGHTS}"
        fn, (scene, cam, _) = port_entry.entry(
            dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
            scatter_lights=N_LIGHTS, **kw)
        ms_frame, counts, img, state, stats = drive(fn, scene, cam, path,
                                                    label, smi)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        stats = [int(x) for x in stats]
        what = ("drawn meshlets" if kw["mode"] == "deferred"
                else "pixels with an opaque surface")
        print(f"{label}: {what} per timed frame {min(stats)}-{max(stats)}")
        breakdown(fn, scene, cam, WARMUP + TIMED, state)

        # the 1080p frame with the plain versions against the kernels'
        est_s = plain_frame_estimate_s(cell, records)
        if est_s < PLAIN_FRAME_BUDGET_S:
            img_k, _, n_k = fn(scene, cam, WARMUP, state)
            out = []
            with plain_paths():
                plain_ms = elapsed_ms(
                    lambda: out.append(fn(scene, cam, WARMUP, state)))
            print(f"{label} frame with the plain versions: ms/frame "
                  f"{plain_ms:.1f} (with the kernels {ms_frame:.3f}); "
                  f"card: {smi}")
            frames_agree(f"{label} kernels vs plain versions", (img_k, n_k),
                         (out[0][0], out[0][2]))
        else:
            print(f"{label} frame with the plain versions: skipped "
                  f"(estimated {est_s:.0f} s > {PLAIN_FRAME_BUDGET_S:.0f} s)")

        # 64x64 frames on the card against the CPU, two frames each
        got = []
        for d in (dev, "cpu"):
            fn64, (sc, cm, _) = port_entry.entry(
                d, scene="plate", n_clusters=64, width=64, height=64,
                scatter_lights=100, **kw)
            _, st, _ = fn64(sc, cm, 0)
            img64, _, n = fn64(sc, cm, 1, st)
            got.append((img64, n))
        frames_agree(f"{cell} plate-64 64x64 cuda vs cpu", *got)
    return flat, launches


@contextlib.contextmanager
def policy(field, name):
    """config.policy.<field> set to name for a with block."""
    from prosper_tpu_torch import config

    with mock.patch.object(config.policy, field, name):
        yield


def capture_shadow_rays(fn, scene, cam):
    """Run one ReSTIR frame; keep the wrapper and whole arguments of its
    one any-hit call, as the frame hands them to the kernel (16x16-block
    order)."""
    from prosper_tpu_torch.render import restir

    with recording_tracer(restir, 1) as calls:
        fn(scene, cam, 0)
    torch.cuda.synchronize()
    if len(calls) != 1:
        raise RuntimeError(f"a ReSTIR frame made {len(calls)} any-hit calls")
    return calls[0]


def check_any_call(label, kern, plain, args, boxes, k3_args=None):
    """An any-hit kernel on one whole shadow set (args = scene arrays, o,
    d, t_min, t_max) against its plain version and, given k3_args (K3's
    slabs, bounds, meta), against K3 on the same rays -> (ok, record)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    *head, o, d, t_min, t_max = args
    t_min = float(t_min)
    t_max = tb.as_tmax(t_max, o.shape[0], o.device)
    args = (*head, o, d, t_min, t_max)
    want, plain_ms = timed_call(lambda: plain(*args))
    got = kern(*args)
    mism = int((got != want).sum())
    ok = mism == 0
    rec = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "occlusion_mismatch": mism, "rays": int(got.shape[0]),
           "live_rays": int((t_max > t_min).sum()),
           "occluded": int(want.sum())}
    if k3_args is not None:
        k3 = (lambda: tb.trace_any_bvh(*k3_args, o, d, t_min, t_max))
        rec["vs_k3_mismatch"] = int((got != k3()).sum())
        tb.check_stack_overflow(o.device)
        rec["k3_same_rays_ms"] = device_ms(k3, 5)
        ok &= rec["vs_k3_mismatch"] == 0
    # an occluded ray needs one cluster's tests at least; a free one every
    # cluster it enters before t_max
    free = ~want
    ops = MOLLER_OPS * 128 * (int(want.sum()) + entered_pairs(
        boxes, o[free], d[free], t_max[free]))
    rec.update(ms=device_ms(lambda: kern(*args), 5), plain_ms=plain_ms,
               **bound(nbytes(*args, got), ops))
    print(f"{label}: ok={ok} {rec}")
    return ok, rec


def endpoint_order(o, d, t_max):
    """A ray order by the Morton code of each live ray's end point (the
    light it is cast to; dead rays last): the coherence sort of the JAX
    package's ReSTIR (restir.py:283-309), on positions the kernel sees."""
    end = o + d * t_max[:, None]
    live = t_max > 0
    lo = torch.where(live[:, None], end, float("inf")).amin(0)
    hi = torch.where(live[:, None], end, float("-inf")).amax(0)
    q = ((end - lo) / torch.clamp_min(hi - lo, 1e-9) * 63.0).clamp(0, 63)
    q = q.to(torch.int64)
    key = torch.zeros_like(q[:, 0])
    for b in range(6):
        for a in range(3):
            key |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return torch.argsort(torch.where(live, key, 1 << 20))


def check_restir_kernels(fns):
    """Phase 8: the shadow rays of one ReSTIR frame with BVH arrays and
    of one without; K10 (and K3) on the first, K7 on the second, each
    against its plain version and K3. Returns (ok, records)."""
    from prosper_tpu_torch.ops import trace as ttrace
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.ops import trace_flat as tf

    fn_b, scene_b, cam_b = fns[True]
    fn_f, scene_f, cam_f = fns[False]
    frame = scene_b["frame"]
    k3_args = (scene_b["geom"]["packed9"], frame["bvh_bounds"],
               frame["bvh_meta"])
    with policy("any_tracer", "stack"):
        func, args_b = capture_shadow_rays(fn_b, scene_b, cam_b)
    if func is not tb.trace_any_bvh:
        raise RuntimeError(f"the BVH frame's shadow rays went to {func}")
    *_, o, d, t_min, t_max = args_b
    ok_all, k10 = check_any_call(
        "K10 ReSTIR shadow rays, BVH frame", tb.trace_any_bvh_dense,
        tb.trace_any_bvh_dense_plain, (*k3_args, o, d, t_min, t_max),
        leaf_boxes(scene_b), k3_args)
    ok, k3 = check_any_call(
        "K3 ReSTIR shadow rays, BVH frame", tb.trace_any_bvh,
        tb.trace_any_bvh_plain, args_b, leaf_boxes(scene_b))
    ok_all &= ok

    func, args_f = capture_shadow_rays(fn_f, scene_f, cam_f)
    if func is not tf.trace_any_flat:
        raise RuntimeError(f"the no-BVH frame's shadow rays went to {func}")
    slabs, mn, mx, o, d, t_min, t_max = args_f
    ok, k7 = check_any_call(
        "K7 ReSTIR shadow rays, no-BVH frame", tf.trace_any_flat,
        tf.trace_any_flat_plain, args_f, (mn, mx), k3_args)
    ok_all &= ok
    # the same rays in two other orders: row-major pixels, and sorted by
    # the end point as the JAX package sorts them; the mask must not move
    _, inverse = ttrace.block_order(W, H, str(o.device))
    for name, perm in (("row_major", inverse),
                       ("endpoint_sorted", endpoint_order(o, d, t_max))):
        po, pd, pt_ = o[perm].contiguous(), d[perm].contiguous(), t_max[perm]
        got = tf.trace_any_flat(slabs, mn, mx, po, pd, t_min, pt_)
        want = tf.trace_any_flat(slabs, mn, mx, o, d, t_min, t_max)[perm]
        mism = int((got != want).sum())
        k7[f"{name}_mismatch"] = mism
        k7[f"{name}_ms"] = device_ms(
            lambda: tf.trace_any_flat(slabs, mn, mx, po, pd, t_min, pt_), 5)
        print(f"K7 in {name} order: {k7[f'{name}_ms']:.3f} ms, mask "
              f"mismatches {mism}")
        ok_all &= mism == 0
    return ok_all, {"trace_any_flat": k7, "trace_any_bvh_dense": k10,
                    "trace_any_bvh": k3}


def run_restir(smi, dev):
    """Phases 8 and 9; returns (records of K7 and K10, K3's ReSTIR
    record, launches per kernel summed over the three configurations)."""
    from prosper_tpu_torch import entry as port_entry

    phase("kernels: any hit")
    fns = {}
    for bvh in (True, False):
        fn, (scene, cam, _) = port_entry.entry(
            dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
            mode="restir", scatter_lights=N_LIGHTS, bvh=bvh)
        fns[bvh] = (fn, scene, cam)
    ok, records = check_restir_kernels(fns)
    print("kernel, plain and bound times on one frame's shadow rays: "
          + ", ".join(f"{k} {r['ms']:.3f} vs {r['plain_ms']:.1f} ms, bound "
                      f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
                      for k, r in records.items()) + f"; card: {smi}")
    if not ok:
        raise RuntimeError("an any-hit kernel disagrees with its plain "
                           "version or with K3")

    phase("restir")
    launches = {}
    for cell, (kw, any_tracer, path) in RESTIR_CELLS.items():
        label = f"{cell} {W}x{H} lights={N_LIGHTS}"
        fn, scene, cam = fns[kw.get("bvh", True)]
        with policy("any_tracer", any_tracer):
            ms_frame, counts, img, state, stats = drive(fn, scene, cam, path,
                                                        label, smi)
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            stats = [int(x) for x in stats]
            print(f"{label}: shadow rays per timed frame {min(stats)}-"
                  f"{max(stats)} of {W * H} pixels; accumulated samples "
                  f"{float(state[1][0, 0]):.0f}")
            breakdown(fn, scene, cam, WARMUP + TIMED, state)
            img_k, _, n_k = fn(scene, cam, WARMUP)
            out = []
            with plain_paths():
                plain_ms = elapsed_ms(
                    lambda: out.append(fn(scene, cam, WARMUP)))
            print(f"{label} frame with the plain versions: ms/frame "
                  f"{plain_ms:.1f} (with the kernels {ms_frame:.3f}); "
                  f"card: {smi}")
            frames_agree(f"{label} kernels vs plain versions", (img_k, n_k),
                         (out[0][0], out[0][2]))
            got = []
            for d in (dev, "cpu"):
                fn64, (sc, cm, _) = port_entry.entry(
                    d, scene="plate", n_clusters=64, width=64, height=64,
                    mode="restir", scatter_lights=100, **kw)
                _, st, _ = fn64(sc, cm, 0)
                img64, _, n = fn64(sc, cm, 1, st)
                got.append((img64, n))
            frames_agree(f"{cell} plate-64 64x64 cuda vs cpu", *got)
    k3 = records.pop("trace_any_bvh")
    return records, k3, launches


def check_pt_flat_kernels(fn, scene, cam):
    """K8 on the first bounce set and K7 on the first shadow set of a
    path-traced frame without BVH arrays, each against its plain version
    -> (ok, {kernel: record of that set})."""
    from prosper_tpu_torch.ops import trace_flat as tf
    from prosper_tpu_torch.render import pt

    bounces = []
    real = pt.trace_closest_flat_full

    def rec(*args):
        if isinstance(args[-1], torch.Tensor):  # a bounce set, not primary
            bounces.append(args)
        return real(*args)

    with recording_tracer(pt, 1) as any_calls, patched(
            (pt, "trace_closest_flat_full", rec)):
        fn(scene, cam, 0)
    torch.cuda.synchronize()
    ok, k8, _ = check_flat_call(
        "K8 pt bvh=False first bounce set", tf.trace_closest_flat_full,
        tf.trace_closest_flat_full_plain, bounces[0], list(range(2, 13)))
    frame = scene["frame"]
    ok7, k7 = check_any_call(
        "K7 pt bvh=False first shadow set", tf.trace_any_flat,
        tf.trace_any_flat_plain, any_calls[0][1],
        (frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]))
    keep = ("live_rays", "ms", "plain_ms", "bound_ms", "bound_by")
    return ok and ok7, {"trace_closest_flat_full": {k: k8[k] for k in keep},
                        "trace_any_flat": {k: k7[k] for k in keep}}


def run_pt_flat(smi, dev, records):
    """Phase 10: the path tracer without BVH arrays. Adds its wavefronts'
    K8 and K7 records to records; returns its launches per kernel."""
    from prosper_tpu_torch import entry as port_entry

    phase("pt bvh=False")
    fn, (scene, cam, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        max_bounces=BOUNCES, bvh=False)
    ok, sets = check_pt_flat_kernels(fn, scene, cam)
    if not ok:
        raise RuntimeError("a flat kernel disagrees with its plain version "
                           "on the path tracer's wavefronts")
    for name, rec in sets.items():
        records[name]["pt_wavefront"] = rec
    label = f"pt bvh=False {W}x{H} bounces={BOUNCES}"
    ms_frame, launches, img, state, rays = drive(fn, scene, cam, PT_FLAT_PATH,
                                                 label, smi)
    rays_frame = sum(int(r) for r in rays) / TIMED
    print(f"{label}: ms/frame {ms_frame:.3f} rays/frame {rays_frame:.0f} "
          f"Mrays/s {rays_frame / ms_frame / 1e3:.3f}")
    breakdown(fn, scene, cam, WARMUP + TIMED, state)

    est_s = 1e-3 * BOUNCES * (records["trace_closest_flat_full"]["plain_ms"]
                              + records["trace_any_flat"]["plain_ms"])
    if est_s < PLAIN_FRAME_BUDGET_S:
        img_k, _, n_k = fn(scene, cam, WARMUP)
        out = []
        with plain_paths():
            plain_ms = elapsed_ms(lambda: out.append(fn(scene, cam, WARMUP)))
        print(f"{label} frame with the plain versions: ms/frame "
              f"{plain_ms:.1f} (with the kernels {ms_frame:.3f}); card: {smi}")
        frames_agree(f"{label} kernels vs plain versions", (img_k, n_k),
                     (out[0][0], out[0][2]))
    else:
        print(f"{label} frame with the plain versions: skipped (estimated "
              f"{est_s:.0f} s > {PLAIN_FRAME_BUDGET_S:.0f} s)")
    got = []
    for d in (dev, "cpu"):
        fn64, (sc, cm, _) = port_entry.entry(
            d, scene="plate", n_clusters=64, width=64, height=64,
            max_bounces=2, bvh=False)
        img64, _, n = fn64(sc, cm, 3)
        got.append((img64, n))
    frames_agree("pt bvh=False plate-64 64x64 frame cuda vs cpu", *got)
    return launches


@contextlib.contextmanager
def recording_bounce(module):
    """Keep the whole arguments of every call of the "any" and
    "closest_full" fns that module.make_bounce_tracer returns, the rays
    copied (the path tracer reuses its ray buffers)."""
    real = module.make_bounce_tracer
    calls = {"any": [], "closest_full": []}

    def make_bounce_tracer(*args, **kw):
        tr = real(*args, **kw)
        if tr is None:
            return None
        out = {}
        for key, fn in tr.items():
            def rec(*a, fn=fn, key=key):
                calls[key].append(fn.args + tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in a))
                return fn(*a)
            out[key] = None if fn is None else rec
        return out

    with mock.patch.object(module, "make_bounce_tracer", make_bounce_tracer):
        yield calls


def tiles_over_cap(mn, mx, o, d, t_max) -> tuple[int, int]:
    """(tiles whose level-1 cull passes more than VIS_CAP clusters,
    tiles) of ops/trace_leafmajor.candidate_lists on these rays, with its
    padding rule."""
    from prosper_tpu_torch.ops import trace_leafmajor as lm
    from prosper_tpu_torch.ops.intersect import packet_aabb_overlap_2d

    pad = (-o.shape[0]) % lm.ENUM_TILE
    o = torch.cat([o, o[:1].expand(pad, 3)]).reshape(-1, lm.ENUM_TILE, 3)
    d = torch.cat([d, torch.zeros_like(d[:pad])]).reshape(-1, lm.ENUM_TILE, 3)
    t_max = torch.cat([t_max, torch.zeros_like(t_max[:pad])])
    over = packet_aabb_overlap_2d(
        o.amin(1), o.amax(1), d.amin(1), d.amax(1), mn, mx,
        t_max.reshape(-1, lm.ENUM_TILE).amax(1)).sum(1) > lm.VIS_CAP
    return int(over.sum()), int(over.shape[0])


def check_run_pairs(label, slabs, blocks, o, d, t_min, t_max, any_hit):
    """K14 on one set of pair blocks against its plain version -> (ok,
    record). Bound: 53 operations x 128 triangles per valid slot (any
    hit: one test for a slot that hits); the bytes the function must
    move on this data: block_leaf, the slot arrays of the non-empty
    blocks, each slotted ray's origin, direction and t_max and each
    listed leaf's 9 Möller rows once, and the whole output."""
    from prosper_tpu_torch.ops import trace_leafmajor as lm

    args = (slabs, *blocks, o, d, t_min, t_max, any_hit)
    want, plain_ms = timed_call(lambda: lm.run_pairs_plain(*args))
    got = lm.run_pairs(*args)
    block_leaf, slot_ray, _ = blocks
    live_blocks = block_leaf >= 0
    valid = blocks[2] & live_blocks[:, None]
    n_valid = int(valid.sum())
    n_bytes = (nbytes(block_leaf, got)
               + int(live_blocks.sum()) * lm.BLOCK * 5
               + torch.unique(slot_ray[valid]).numel() * 28
               + torch.unique(block_leaf[live_blocks]).numel() * 9 * LANES * 4)
    if any_hit:
        mism = int(((got != want) & valid).sum())
        err = float(((got.float() - want.float()).abs() * valid).max())
        hits = int((want & valid).sum())
        tests = LANES * (n_valid - hits) + hits
    else:
        g, w = got.transpose(1, 2)[valid], want.transpose(1, 2)[valid]
        mism = int(((g[:, 1] != w[:, 1])
                    | ((g[:, 0] - w[:, 0]).abs() > T_ATOL + T_RTOL
                       * w[:, 0].abs())).sum())
        err = float((g - w).abs().amax()) if n_valid else 0.0
        hits = int((w[:, 1] >= 0).sum())
        tests = LANES * n_valid
    rec = {"max_abs_err": err, "mismatch": mism, "valid_pairs": n_valid,
           "blocks": int((blocks[0] >= 0).sum()),
           "block_capacity": int(blocks[0].shape[0]), "slot_hits": hits,
           "ms": device_ms(lambda: lm.run_pairs(*args), 5),
           "plain_ms": plain_ms, **bound(n_bytes, MOLLER_OPS * tests)}
    print(f"K14 {label}: ok={mism == 0} {rec}")
    return mism == 0, rec


def check_trace_set(label, args, any_hit):
    """One incoherent trace set (slabs, bounds, meta, wc_min, wc_max, o, d,
    t_min, t_max) as a frame hands it to the leaf-major hybrid: its heavy,
    pair and block counts; K14 against its plain version on the hybrid's
    blocks (any_hit as the set) and on the blocks of every ray's first 8
    candidates; the hybrid against K2 or K3 on the same rays. Returns
    (ok, record of K14 on the hybrid's blocks, summary)."""
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.ops import trace_leafmajor as lm

    slabs, bounds, meta, mn, mx, o, d, t_min, t_max = args
    t_min = float(t_min)
    t_max = tb.as_tmax(t_max, o.shape[0], o.device)
    C = mn.shape[0]
    heavy, pairs, _ = lm.light_pairs(mn, mx, o, d, t_min, t_max)
    live = t_max > t_min
    over, tiles = tiles_over_cap(mn, mx, o, d, t_max)
    summary = {"rays": int(o.shape[0]), "live_rays": int(live.sum()),
               "heavy_live_rays": int((heavy & live).sum()),
               "heavy_share_of_live": float((heavy & live).sum())
               / max(1, int(live.sum())),
               "tiles_over_vis_cap": over, "tiles": tiles}
    ok, rec = check_run_pairs(f"{label}, hybrid blocks", slabs,
                              lm.build_blocks(*pairs, C)[:3], o, d, t_min,
                              t_max, any_hit)
    full = lm.enumerate_pairs_tiled(mn, mx, o, d, t_min, t_max)[:3]
    ok_f, rec_f = check_run_pairs(f"{label}, every ray's first 8 candidates",
                                  slabs, lm.build_blocks(*full, C)[:3], o, d,
                                  t_min, t_max, any_hit)
    ok &= ok_f
    rec["first_8_candidates"] = {k: rec_f[k] for k in (
        "valid_pairs", "blocks", "ms", "plain_ms", "bound_ms", "bound_by")}

    # the hybrid against the packet kernel on the same rays
    scene = (slabs, bounds, meta, mn, mx)
    if any_hit:
        def hybrid():
            return lm.trace_any_leafmajor_safe(*scene, o, d, t_min, t_max)

        def packet():
            return tb.trace_any_bvh(slabs, bounds, meta, o, d, t_min, t_max)
        mism = int((hybrid() != packet()).sum())
        ok_h = mism == 0
        counts = {"occlusion_mismatch": mism}
    else:
        def hybrid():
            return lm.trace_closest_leafmajor_safe(*scene, o, d, t_min, t_max)

        def packet():
            return tb.trace_closest_bvh(slabs, bounds, meta, o, d, t_min,
                                        t_max)
        h = hybrid()
        rows = torch.stack([torch.where(h["tri"] >= 0, h["t"], t_max),
                            h["tri"].float(), h["u"], h["v"]], dim=1)
        ok_h, counts, _ = compare_rows(rows, packet()[:, :4], [2, 3])
    tb.check_stack_overflow(o.device)
    summary.update(hybrid_ms=device_ms(hybrid, 3),
                   packet_same_rays_ms=device_ms(packet, 3),
                   hybrid_vs_packet=counts)
    print(f"{label}: hybrid vs {'K3' if any_hit else 'K2'} ok={ok_h} "
          f"{summary}")
    return ok and ok_h, rec, summary


def check_k9(o, d, t_min, t_max, scene):
    """K9 on the path tracer's first bounce set against its plain version
    and K2, without and with a random skip mask -> (ok, record)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    args = (slabs, frame["bvh_bounds"], frame["bvh_meta"], o, d, t_min, t_max)
    k2 = tb.trace_closest_bvh(*args)
    tb.check_stack_overflow(o.device)
    C = slabs.shape[0]
    gen = torch.Generator().manual_seed(5)
    rand = (torch.rand(C, generator=gen) > 0.3).to(o.device)
    ok_all, rec = True, None
    for name, mask in (("unmasked", None), ("random skip_mask", rand)):
        want, plain_ms = timed_call(
            lambda: tb.trace_closest_bvh_dense_plain(*args, skip_mask=mask))
        got = tb.trace_closest_bvh_dense(*args, skip_mask=mask)
        ok, counts, err = compare_rows(got, want, [2, 3])
        tri = got[:, 1].long()
        if mask is None:
            ok_k2, vs_k2, _ = compare_rows(got, k2, [2, 3])
        else:
            # the masked clusters never hit; a ray whose K2 hit lies in a
            # kept cluster keeps it
            in_masked = int(((tri >= 0) & ~mask[tri.clamp_min(0) // LANES])
                            .sum())
            k2_tri = k2[:, 1].long()
            kept = (k2_tri >= 0) & mask[k2_tri.clamp_min(0) // LANES]
            ok_k2, vs_k2, _ = compare_rows(got[kept], k2[kept], [2, 3])
            vs_k2["hits_in_masked_clusters"] = in_masked
            ok_k2 &= in_masked == 0
        print(f"K9 PT first bounce set, {name}: ok={ok} {counts}; vs K2 "
              f"ok={ok_k2} {vs_k2}")
        ok_all &= ok and ok_k2
        r = {"max_abs_err": err, "rays": int(got.shape[0]),
             "live_clusters": C if mask is None else int(mask.sum()),
             "ms": device_ms(
                 lambda: tb.trace_closest_bvh_dense(*args, skip_mask=mask), 5),
             "plain_ms": plain_ms,
             **bound(nbytes(*args, mask, got),
                     closest_ops(leaf_boxes(scene), o, d, want, t_max, mask))}
        if rec is None:
            rec = {**r, "k2_same_rays_ms": device_ms(
                lambda: tb.trace_closest_bvh(*args), 5)}
        else:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["skip_mask"] = {k: r[k] for k in (
                "live_clusters", "ms", "plain_ms", "bound_ms", "bound_by")}
    return ok_all, rec


def check_leafmajor_kernels(dev):
    """Phase 11: the first bounce and shadow sets of a path-traced frame
    and the shadow set of a ReSTIR frame under leafmajor (check_trace_set
    each), and K9 on the bounce set. Returns (ok, records, summaries)."""
    from prosper_tpu_torch import entry as port_entry
    from prosper_tpu_torch.render import pt, restir

    fn, (scene, cam, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        max_bounces=BOUNCES)
    with policy("bounce_tracer", "leafmajor"), \
            recording_bounce(pt) as pt_calls:
        fn(scene, cam, 0)
    fn_r, (scene_r, cam_r, _) = port_entry.entry(
        dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
        mode="restir", scatter_lights=N_LIGHTS)
    with policy("bounce_tracer", "leafmajor"), \
            recording_bounce(restir) as r_calls:
        fn_r(scene_r, cam_r, 0)
    torch.cuda.synchronize()
    if not (pt_calls["closest_full"] and pt_calls["any"]
            and len(r_calls["any"]) == 1):
        raise RuntimeError("the leafmajor frames did not take the hybrid")
    ok_all, summaries = True, {}
    ok, k14, summaries["pt_first_bounce_set"] = check_trace_set(
        "PT first bounce set", pt_calls["closest_full"][0], False)
    ok_all &= ok
    for key, args in (("pt_first_shadow_set", pt_calls["any"][0]),
                      ("restir_shadow_set", r_calls["any"][0])):
        ok, rec, summaries[key] = check_trace_set(key.replace("_", " "), args,
                                                  True)
        ok_all &= ok
        k14[key] = {k: rec[k] for k in (
            "valid_pairs", "blocks", "ms", "plain_ms", "bound_ms",
            "bound_by")}
        k14["max_abs_err"] = max(k14["max_abs_err"], rec["max_abs_err"])
    *_, o, d, t_min, t_max = pt_calls["closest_full"][0]
    ok, k9 = check_k9(o, d, float(t_min), t_max, scene)
    return (ok_all and ok, {"run_pairs": k14, "trace_closest_bvh_dense": k9},
            summaries)


def run_leafmajor(smi, dev):
    """Phases 11 and 12; returns (records of K14 and K9, launches per
    kernel summed over the two leafmajor frames)."""
    from prosper_tpu_torch import entry as port_entry

    phase("kernels: leaf-major")
    ok, records, summaries = check_leafmajor_kernels(dev)
    print("leaf-major trace sets: " + json.dumps(summaries))
    print("kernel, plain and bound times: " + ", ".join(
        f"{k} {r['ms']:.3f} vs {r['plain_ms']:.1f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})"
        for k, r in records.items()) + f"; card: {smi}")
    if not ok:
        raise RuntimeError("a leaf-major kernel disagrees with its plain "
                           "version, or the hybrid with K2/K3")

    phase("leafmajor")
    launches = {}
    for cell, (kw, path) in LEAFMAJOR_CELLS.items():
        label = f"{cell} {W}x{H}"
        fn, (scene, cam, _) = port_entry.entry(
            dev, scene="plate", n_clusters=N_CLUSTERS, width=W, height=H,
            **kw)
        with policy("bounce_tracer", "leafmajor"):
            ms_frame, counts, img, state, stats = drive(fn, scene, cam, path,
                                                        label, smi)
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            stats = [int(x) for x in stats]
            print(f"{label}: stat per timed frame {min(stats)}-{max(stats)} "
                  f"(rays, or shadow rays of {W * H} pixels)")
            breakdown(fn, scene, cam, WARMUP + TIMED, state)
            img_k, _, n_k = fn(scene, cam, WARMUP)
            out = []
            with plain_paths():
                plain_ms = elapsed_ms(lambda: out.append(fn(scene, cam,
                                                            WARMUP)))
            print(f"{label} frame with the plain versions: ms/frame "
                  f"{plain_ms:.1f} (with the kernels {ms_frame:.3f}); "
                  f"card: {smi}")
            frames_agree(f"{label} kernels vs plain versions", (img_k, n_k),
                         (out[0][0], out[0][2]))
            got = []
            for d in (dev, "cpu"):
                kw64 = {**kw, "scatter_lights": 100} if kw.get(
                    "mode") == "restir" else {**kw, "max_bounces": 2}
                fn64, (sc, cm, _) = port_entry.entry(
                    d, scene="plate", n_clusters=64, width=64, height=64,
                    **kw64)
                _, st, _ = fn64(sc, cm, 0)
                img64, _, n = fn64(sc, cm, 1, st)
                got.append((img64, n))
            frames_agree(f"{cell} plate-64 64x64 cuda vs cpu", *got)
    return records, launches


def load_world(directory):
    """Phase 13's scene: write the plate glTF, load it through World with
    the native mesh library, and time each step. Returns (path, frame
    arrays, timings)."""
    from unittest import mock as _mock

    from prosper_tpu_torch import testing
    from prosper_tpu_torch.scene import native
    from prosper_tpu_torch.scene import world as world_mod
    from prosper_tpu_torch.scene.textures import build_texture_arena

    times = {}
    t0 = time.perf_counter()
    path = testing.write_plate_gltf(directory, N_CLUSTERS,
                                    n_instanced=WORLD_INSTANCED,
                                    scatter_lights=N_LIGHTS)
    times["write_gltf_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native asset pipeline did not load")
    times["native_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world = world_mod.World(path)  # a cold cache: processed and written
    times["world_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arena = build_texture_arena(world.doc, scene_path=path)
    times["texture_arena_s"] = time.perf_counter() - t0
    real = world_mod.pack_nodes8
    packed = []

    def timed_pack(bvh):
        t = time.perf_counter()
        out = real(bvh)
        packed.append(time.perf_counter() - t)
        return out

    with _mock.patch.object(world_mod, "pack_nodes8", timed_pack):
        t0 = time.perf_counter()
        frame = world.frame_arrays(0.0)
        times["frame_arrays_s"] = time.perf_counter() - t0
    times["pack_nodes8_s"] = packed[0]
    print(f"world: {len(world.meshes)} meshes, "
          f"{len(world.draw_instances.mesh)} draw instances, "
          f"{world.n_world_clusters} world clusters, {world.n_real_tris} "
          f"triangles, {int(frame['lights']['point_count'])} point lights, "
          f"texture arena {tuple(arena.data.shape)} with "
          f"{arena.n_mips.tolist()} mips, BVH2 depth {frame['bvh_depth']}, "
          f"{frame['bvh_nodes8'].shape[0]} 8-wide nodes; "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return path, frame, times


def run_world_frames(smi, dev, path, tmp):
    """Phase 13: the path tracer and the culled deferred frame of the
    glTF World scene, each checked as phase 4 checks its frame, and the
    PT frame's kernels and the deferred frame's K4 phases as phase 3
    checks them. Returns the launches per kernel, the World scene's PT
    frame call (for phase 14) and {"world_pt": the records of K1-K3 on
    its wavefronts, "world_deferred": K4's}."""
    from prosper_tpu_torch import entry as port_entry
    from prosper_tpu_torch import testing

    small = testing.write_plate_gltf(os.path.join(tmp, "small"), 64,
                                     n_instanced=8, scatter_lights=100)
    cells = {"world pt": ({"max_bounces": BOUNCES}, PT_PATH),
             "world deferred culled": ({"mode": "deferred",
                                        "use_culling": True},
                                       DEFERRED_PATH[True])}
    launches, pt_call, records = {}, None, {}
    for cell, (kw, path_kernels) in cells.items():
        label = f"{cell} {W}x{H}"
        fn, (scene, cam, _) = port_entry.entry(dev, scene=path, width=W,
                                               height=H, **kw)
        if pt_call is None:
            pt_call = (fn, scene, cam)
        ms_frame, counts, img, state, stats = drive(fn, scene, cam,
                                                    path_kernels, label, smi)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        stats = [int(x) for x in stats]
        what = "rays" if "pt" in cell else "drawn meshlets"
        print(f"{label}: {what} per timed frame {min(stats)}-{max(stats)}")
        breakdown(fn, scene, cam, WARMUP + TIMED, state)
        if "pt" in cell:
            ok, records["world_pt"], _ = check_pt_kernels(label, fn, scene,
                                                          cam, W, H)
        else:
            _, seen = culled_phases(lambda: fn(scene, cam, WARMUP, state))
            ok, k4 = check_k4_phases(label, scene, seen)
            records["world_deferred"] = {"trace_closest_bvh_full": k4}
        if not ok:
            raise RuntimeError(f"{label}: a kernel disagrees with its plain "
                               "version or with the one-thread walk")
        keep = state if "deferred" in cell else None
        img_k, _, n_k = fn(scene, cam, WARMUP, keep)
        out = []
        with plain_paths():
            plain_ms = elapsed_ms(
                lambda: out.append(fn(scene, cam, WARMUP, keep)))
        print(f"{label} frame with the plain versions: ms/frame "
              f"{plain_ms:.1f} (with the kernels {ms_frame:.3f}); card: {smi}")
        frames_agree(f"{label} kernels vs plain versions", (img_k, n_k),
                     (out[0][0], out[0][2]))
        got = []
        for d in (dev, "cpu"):
            kw64 = {**kw, "max_bounces": 2} if "pt" in cell else kw
            fn64, (sc, cm, _) = port_entry.entry(d, scene=small, width=64,
                                                 height=64, **kw64)
            _, st, _ = fn64(sc, cm, 0)
            img64, _, n = fn64(sc, cm, 1, st)
            got.append((img64, n))
        frames_agree(f"{cell} glTF plate-64 64x64 cuda vs cpu", *got)
    return launches, pt_call, records


def check_closest8(label, kern, plain, ref, args, ref_args, attr_cols,
                   boxes):
    """An 8-wide closest-hit kernel on one ray set against its plain
    version (equal: max_abs_err 0 expected) and the BVH2 kernel `ref` on
    the same rays (tri equal except exact t ties, t within rtol 1e-5) ->
    (ok, record)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    *_, o, d, t_min, t_max = args
    want, plain_ms = timed_call(lambda: plain(*args))
    got = kern(*args)
    tb.check_stack_overflow(o.device)
    ok, counts, err = compare_rows(got, want, attr_cols)
    ref_rows = ref(*ref_args)
    tb.check_stack_overflow(o.device)
    ok_ref, vs_ref, _ = compare_rows(got, ref_rows, attr_cols)
    rec = {"max_abs_err": err, "rays": int(got.shape[0]),
           "live_rays": int((t_max > t_min).sum()),
           "ms": device_ms(lambda: kern(*args), 5), "plain_ms": plain_ms,
           f"{ref.__name__}_same_rays_ms": device_ms(lambda: ref(*ref_args),
                                                     5),
           f"vs_{ref.__name__}": vs_ref,
           **bound(nbytes(*args, got), closest_ops(boxes, o, d, want, t_max))}
    print(f"{label}: ok={ok} {counts}; vs {ref.__name__} ok={ok_ref}; "
          f"{rec['ms']:.3f} ms, plain {plain_ms:.1f} ms, "
          f"{ref.__name__} {rec[f'{ref.__name__}_same_rays_ms']:.3f} ms, "
          f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    return ok and ok_ref, rec


def check_bvh8_kernels(smi, scene, cam):
    """Phase 14 on the World scene's arrays: K12 on the block-order
    pinhole rays, K11 and K12 on the cosine bounce set, K13 on it with
    t_max 8, each against its plain version and its BVH2 twin; K4 on the
    pinhole rays against X3a (walk_twins).
    Returns (ok, records, K4's record)."""
    from prosper_tpu_torch.ops import trace_bvh as tb
    from prosper_tpu_torch.scripts.bench_visit_breakdown import (
        bounce_rays,
        primary_rays,
    )

    geom, frame = scene["geom"], scene["frame"]
    dev = geom["packed_full"].device
    p40, p9, n8 = geom["packed_full"], geom["packed9"], frame["bvh_nodes8"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    boxes = leaf_boxes(scene)
    t_min, t_any = 1e-4, 0.1  # what the Pallas kernels hard-code
    o, d = primary_rays(cam, W, H, dev)
    inf = torch.full((o.shape[0],), float("inf"), device=dev)
    full = list(range(2, 13))
    ok_all, k12 = check_closest8(
        f"K12 world {W}x{H} primary rays (block order)",
        tb.trace_closest_bvh8_full, tb.trace_closest_bvh8_full_plain,
        tb.trace_closest_bvh_full, (p40, n8, o, d, t_min, inf),
        (p40, *bvh, o, d, t_min, inf), full, boxes)
    primary = tb.trace_closest_bvh_full(p40, *bvh, o, d, t_min, inf)
    tb.check_stack_overflow(dev)
    k4 = walk_twins(
        f"K4 world {W}x{H} primary rays (block order, "
        f"{k12['trace_closest_bvh_full_same_rays_ms']:.3f} ms)", p40, bvh,
        (o, d, t_min, inf), primary)
    k4["ms"] = k12["trace_closest_bvh_full_same_rays_ms"]
    ok_all &= k4["walk_rows_equal"]
    ob, db, tb_max, live = bounce_rays(o, d, primary)
    print(f"bounce set: {live} live rays of {ob.shape[0]}")
    ok, k11 = check_closest8(
        "K11 world bounce set", tb.trace_closest_bvh8,
        tb.trace_closest_bvh8_plain, tb.trace_closest_bvh,
        (p9, n8, ob, db, t_min, tb_max), (p9, *bvh, ob, db, t_min, tb_max),
        [2, 3], boxes)
    ok_all &= ok
    ok, k12b = check_closest8(
        "K12 world bounce set", tb.trace_closest_bvh8_full,
        tb.trace_closest_bvh8_full_plain, tb.trace_closest_bvh_full,
        (p40, n8, ob, db, t_min, tb_max), (p40, *bvh, ob, db, t_min, tb_max),
        full, boxes)
    ok_all &= ok
    k12["bounce_set"] = {k: v for k, v in k12b.items()
                         if k != "vs_trace_closest_bvh_full"}
    k12["max_abs_err"] = max(k12["max_abs_err"], k12b["max_abs_err"])
    tm8 = torch.where(tb_max > 1, 8.0, 0.0)
    ok, k13 = check_any_call("K13 world bounce set, t_max 8",
                             tb.trace_any_bvh8, tb.trace_any_bvh8_plain,
                             (p9, n8, ob, db, t_any, tm8), boxes,
                             (p9, *bvh))
    ok_all &= ok
    print("8-wide against BVH2 on the same rays: K12/K4 primary "
          f"{k12['ms']:.3f}/{k12['trace_closest_bvh_full_same_rays_ms']:.3f}"
          f" ms, K11/K2 bounce {k11['ms']:.3f}/"
          f"{k11['trace_closest_bvh_same_rays_ms']:.3f} ms, K12/K4 bounce "
          f"{k12b['ms']:.3f}/{k12b['trace_closest_bvh_full_same_rays_ms']:.3f}"
          f" ms, K13/K3 bounce t_max 8 {k13['ms']:.3f}/"
          f"{k13['k3_same_rays_ms']:.3f} ms; card: {smi}")
    return ok_all, {"trace_closest_bvh8": k11, "trace_closest_bvh8_full": k12,
                    "trace_any_bvh8": k13}, k4


def sm_clock_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock of card 0 in MHz, from nvidia-smi."""
    cur, top = sh(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                   "--format=csv,noheader,nounits"]).splitlines()[0].split(",")
    return float(cur), float(top)


def check_walk(label, table, rays, rec):
    """X1 on one bounce set against its plain version (leaves and counts
    equal) -> (ok, record)."""
    from prosper_tpu_torch.experiments import trace_wavefront as tw

    o, d, t_max = rays
    (want_l, want_c, steps), plain_ms = timed_call(
        lambda: tw.walk_plain(table, o, d, t_max))
    got_l, got_c = tw.walk_leaves(table, o, d, t_max)
    ok = torch.equal(got_l, want_l) and torch.equal(got_c, want_c)
    live = t_max > 0
    c = got_c[live].double()
    out = {"max_abs_err": float((got_c - want_c).abs().max()),
           "rays": int(o.shape[0]), "live_rays": int(live.sum()),
           "leaves_per_ray_mean": float(c.mean()),
           "leaves_per_ray_max": int(c.max()),
           "overflow_share": float((c > tw.L_CAP).double().mean()),
           "steps_per_ray_mean": float(steps[live].double().mean()),
           "ms": device_ms(lambda: tw.walk_leaves(table, o, d, t_max), 5),
           "plain_ms": plain_ms,
           **bound(nbytes(table, o, d, t_max, got_l, got_c),
                   SLAB_OPS * int(steps.sum()))}
    print(f"X1 walk_leaves {label}: ok={ok} leaves/ray mean "
          f"{out['leaves_per_ray_mean']:.3f} max {out['leaves_per_ray_max']}, "
          f"overflow share {out['overflow_share']:.5f}; {out['ms']:.3f} ms, "
          f"plain {plain_ms:.1f} ms, bound {out['bound_ms']:.3f} ms "
          f"({out['bound_by']}); entry point: {rec['walk_ms']:.3f} ms")
    return ok, out


def check_visits(label, scene, rays, rows, rec):
    """X3a on one bounce set: the counting K2's rows (counted in the entry
    point's run) against its plain version (equal) and rows 0-5 against
    K2's on the same rays -> (ok, record)."""
    from prosper_tpu_torch.ops import trace_bvh as tb

    o, d, t_max = rays
    args = (scene["geom"]["packed9"], scene["frame"]["bvh_bounds"],
            scene["frame"]["bvh_meta"], o, d, 1e-4, t_max)
    want, plain_ms = timed_call(lambda: tb.trace_closest_bvh_visits_plain(
        *args))
    k2 = tb.trace_closest_bvh(*args)
    tb.check_stack_overflow(o.device)
    ok = torch.equal(rows, want) and torch.equal(rows[:, 0:6], k2[:, 0:6])
    both = (rows[:, 1] >= 0) & (want[:, 1] >= 0)
    err = float(torch.where(both[:, None], (rows - want).abs(), 0.0).amax())
    out = {"max_abs_err": err, "rays": int(o.shape[0]),
           "live_rays": rec["live_rays"], "hits": rec["hits"],
           "leaf_visits_per_ray": rec["leaf_visits"],
           "interior_nodes_per_ray": rec["node_pops"],
           "leaves_before_hit_per_ray": rec["leaves_before_hit"],
           "leaves_entered_per_ray": rec["leaves_entered"],
           "ms": rec["visits_kernel_ms"], "k2_same_rays_ms": rec["k2_ms"],
           "plain_ms": plain_ms,
           **bound(nbytes(*args[:5], t_max, rows),
                   closest_ops(leaf_boxes(scene), o, d, rows, t_max))}
    v, p = rec["leaf_visits"], rec["node_pops"]
    print(f"X3a visits {label}: ok={ok}; per live ray: leaves tested mean "
          f"{v['mean']:.3f} (p50 {v['p50']:.0f}, p99 {v['p99']:.0f}, max "
          f"{v['max']:.0f}), interior nodes {p['mean']:.3f}, leaves entered "
          f"before the hit {rec['leaves_before_hit']['mean']:.3f}, before "
          f"t_max {rec['leaves_entered']['mean']:.3f}; K2 {rec['k2_ms']:.3f} "
          f"ms, counting K2 {out['ms']:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {out['bound_ms']:.3f} ms ({out['bound_by']})")
    return ok, out


def plucker_library_ms(cols, rows, iters) -> float:
    """One torch.matmul that computes the four Plücker products of
    `iters` blocks of these rays, [d | o x d | o] (iters * 256, 9) @ (9,
    512) in TF32: the yardstick beside the tensor-core loop (the port
    never calls it)."""
    o = cols[0, 0:3].T
    d = cols[0, 3:6].T
    a = torch.cat([d, torch.linalg.cross(o, d), o], dim=1)
    b = torch.zeros((9, 512), device=cols.device)
    b[0:6, 0:128] = rows[0:6]
    b[0:6, 128:256] = rows[12:18]
    b[0:3, 256:384] = rows[18:21]
    b[6:9, 384:512] = rows[18:21]
    a = a.repeat(iters, 1)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return device_ms(lambda: torch.matmul(a, b), 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def loop_bound(variant, rays, iters, one_block) -> dict:
    """The triangle loops' bound: Möller 53 float32 operations a test;
    Plücker 36 TF32 operations a pair (the products at their real K) at
    495 TFLOP/s plus its epilogue at 67 TFLOP/s. One block is held to one
    SM's share of the card."""
    pairs = iters * rays * LANES
    share = 1.0 / H100_SMS if one_block else 1.0
    if variant == "moller":
        ms = pairs * MOLLER_OPS / (FP32_OPS_PER_S * share) * 1e3
    else:
        ms = (pairs * PLUCKER_PRODUCT_OPS / (TF32_OPS_PER_S * share)
              + pairs * PLUCKER_EPILOGUE_OPS / (FP32_OPS_PER_S * share)) * 1e3
    return {"bound_ms": ms, "bound_by": "operations", "bound_pairs": pairs}


def plucker_vs_plain(slab, cols, t):
    """ops/plucker.tf32_agreement of a tensor-core X2 loop's last t on
    cols against the TF32 plain block; X2's chain holds t_upper at inf."""
    from prosper_tpu_torch.ops import bench_kernels as bk
    from prosper_tpu_torch.ops.plucker import (
        plucker_rows_from_slab,
        tf32_agreement,
    )

    o = cols[:, 0:3].transpose(1, 2).reshape(-1, 3)
    d = cols[:, 3:6].transpose(1, 2).reshape(-1, 3)
    return tf32_agreement(plucker_rows_from_slab(slab), o, d, bk.T_MIN,
                          float("inf"), t)


def check_isect_loops(mxu, dev):
    """X2's three loops against their plain versions at one block (the
    script's 256 rays) and at full card (bench_mxu_isect.block_cols'
    distinct rays), NV iterations: the entry point's best and a keep_t
    launch's best and last t. Möller equal. The tensor-core Plücker loops:
    best equal, and against the TF32 plain block (ops/plucker.py
    tf32_agreement) no hit/miss mismatch off the border and, where both
    hit, t within rtol 1e-5 plus the bound of a reordered sum; at one
    block also against Möller by the script's bar, 99.95% of the pairs
    and t within rtol 1e-2 -> (ok, records)."""
    from prosper_tpu_torch.experiments import bench_mxu_isect as bmi
    from prosper_tpu_torch.ops import bench_kernels as bk
    from prosper_tpu_torch.ops.plucker import plucker_rows_from_slab

    runs = {(r["variant"], r["blocks"]): r for r in mxu["runs"]}
    full_blocks = max(b for _, b in runs)
    ok_all, records, t_moller = True, {}, None
    for variant in bmi.VARIANTS:
        kind = bk.MOLLER if variant == "moller" else bk.PLUCKER
        ok, err, rec = True, 0.0, {}
        for blocks in (1, full_blocks):
            slab, cols = bmi.block_cols(blocks, dev)
            best, t = bmi.LOOPS[variant](bmi.loop_input(variant, slab), cols,
                                         bmi.NV, keep_t=True)
            (want_best, want_t), plain_ms = timed_call(
                lambda: bk.isect_loop_plain(kind, bk.CHAIN_X2, slab, cols,
                                            bmi.NV, keep_t=True))
            run = runs[(variant, blocks)]
            ok &= (torch.equal(best, want_best)
                   and torch.equal(run["best"], want_best))
            both = torch.isfinite(t) & torch.isfinite(want_t)
            err = max(err, float(torch.where(both, (t - want_t).abs(),
                                             0.0).amax()))
            part = {"rays": TILE_RAYS * blocks, "iters": bmi.NV,
                    "ms": run["ms"], "us_per_visit": run["us_per_visit"],
                    "plain_ms": plain_ms,
                    **loop_bound(variant, TILE_RAYS * blocks, bmi.NV,
                                 blocks == 1)}
            if variant == "moller":
                ok &= torch.equal(t, want_t)
                if blocks == 1:
                    t_moller = t
            else:
                a = plucker_vs_plain(slab, cols, t)
                ok &= (bool(torch.isinf(want_best).all())
                       and a["mismatches"] == 0 and a["t_err_ratio"] <= 1.0)
                part["vs_tf32_plain"] = a
                if blocks == 1:
                    agree, rel = bmi.agreement(t_moller, t)
                    ok &= agree >= bmi.AGREEMENT and rel <= 1e-2
                    part.update({
                        "hit_agreement_vs_moller": agree,
                        "t_rel_err_vs_moller": rel,
                        "library_ms": plucker_library_ms(
                            cols, plucker_rows_from_slab(slab), bmi.NV)})
            if blocks == 1:
                rec.update(part)
            else:
                rec["full_card"] = {"blocks": blocks, **part}
        rec["max_abs_err"] = err
        full = rec["full_card"]
        print(f"X2 {variant}: ok={ok} {rec['ms']:.3f} ms at one block "
              f"({rec['us_per_visit']:.4f} us/visit), {full['ms']:.3f} ms at "
              f"{full['blocks']} blocks ({full['us_per_visit']:.5f} us/visit "
              f"per block); plain {rec['plain_ms']:.1f} ms, "
              f"{full['plain_ms']:.1f} ms; bound {rec['bound_ms']:.3f} ms one "
              f"block, {full['bound_ms']:.3f} ms full; max abs t err {err:.3g}")
        if variant != "moller":
            for label, part in (("one block", rec), ("full card", full)):
                print(f"  vs TF32 plain, {label}: {part['vs_tf32_plain']}")
            print(f"  vs Möller, one block: agreement "
                  f"{rec['hit_agreement_vs_moller']:.6f}, t rel err "
                  f"{rec['t_rel_err_vs_moller']:.3g}; library "
                  f"{rec['library_ms']:.3f} ms")
        ok_all &= ok
        records[f"isect_loop_{variant}"] = rec
    return ok_all, records


def check_moller_unit(label, tensors, rec):
    """X3b on one bounce set, cluster 0's slab: the chain loop on the
    first 256 rays at K = 1024 and on the whole set at K = 32, as the
    entry point ran it, against its plain version: the entry point's
    best and a keep_t launch's best and last t equal -> (ok, record)."""
    from prosper_tpu_torch.ops import bench_kernels as bk
    from prosper_tpu_torch.scripts import bench_visit_breakdown as bvb

    o, d, _ = tensors["rays"]
    slab = tensors["unit_slab"]
    cols = bk.cols_from_rays(o, d)
    ok, err, plain = True, 0.0, {}
    for key, c, k in (("256_rays", cols[0:1], bvb.K_UNIT),
                      ("set", cols, bvb.K_SET)):
        best, t = bk.moller_chain_loop(slab, c, k, keep_t=True)
        (want_b, want_t), plain[key] = timed_call(lambda: bk.isect_loop_plain(
            bk.MOLLER, bk.CHAIN_X3B, slab, c, k, keep_t=True))
        ok &= (torch.equal(best, want_b) and torch.equal(t, want_t)
               and torch.equal(tensors["unit_best"][key], want_b))
        fin = torch.isfinite(want_t)
        err = max(err, float(torch.where(fin, (t - want_t).abs(), 0.0).amax()))
    unit = rec["moller_unit"]
    one, whole = unit["256_rays"], unit["set"]
    out = {"max_abs_err": err, "rays": one["rays"], "iters": one["k"],
           "ms": one["ms"], "ns_per_ray_visit": one["ns_per_ray_visit"],
           "plain_ms": plain["256_rays"],
           **loop_bound("moller", one["rays"], one["k"], True),
           "set": {"rays": whole["rays"], "iters": whole["k"],
                   "ms": whole["ms"],
                   "ns_per_ray_visit": whole["ns_per_ray_visit"],
                   "plain_ms": plain["set"],
                   **loop_bound("moller", whole["rays"], whole["k"], False)},
           "est_moller_share_ms": rec["est_moller_share_ms"]}
    print(f"X3b moller unit {label}: ok={ok} {one['ms']:.3f} ms for 256 rays "
          f"x {one['k']} ({one['ns_per_ray_visit']:.4f} ns per ray visit), "
          f"{whole['ms']:.3f} ms for {whole['rays']} rays x {whole['k']} "
          f"({whole['ns_per_ray_visit']:.5f} ns); est Möller share of K2 "
          f"{rec['est_moller_share_ms']:.3f} ms of {rec['k2_ms']:.3f}; plain "
          f"{plain['256_rays']:.1f} ms, {plain['set']:.1f} ms the set; bound "
          f"{out['bound_ms']:.3f} ms one block, {out['set']['bound_ms']:.3f} "
          f"ms the set")
    return ok, out


def check_probes(loops, dev):
    """X3c-f: the entry point's outputs (the script's inputs) and a run on
    seeded inputs against the plain versions (equal); the bound is the
    iteration count times the cycles of one iteration's dependence chain
    at the SM clock nvidia-smi reads just after -> (ok, records)."""
    from prosper_tpu_torch.ops import bench_kernels as bk
    from prosper_tpu_torch.scripts import bench_loop_overhead as blo

    cur, top = sm_clock_mhz()
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, 128),
                        dtype=torch.int32, device=dev)
    v = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    v[2:4] = np.abs(v[2:4]) * 0.5
    v[6:8] = np.abs(v[6:8]) * 0.5
    seeded = {"s": s, "v": torch.as_tensor(v, device=dev)}
    plain_of = {bk.loop_flat: bk.loop_flat_plain,
                bk.loop_nested: bk.loop_nested_plain,
                bk.loop_cond: bk.loop_cond_plain,
                bk.loop_vec: bk.loop_vec_plain}
    ok_all, records = True, {}
    for name, (fn, x, counts, iters) in blo.probes(dev).items():
        plain = plain_of[fn]
        want, plain_ms = timed_call(lambda: plain(x, *counts))
        xs = seeded["v" if fn is bk.loop_vec else "s"]
        ok = (torch.equal(loops[name]["out"], want)
              and torch.equal(fn(xs, *counts), plain(xs, *counts)))
        chain = PROBE_CHAIN_CYCLES[fn.__name__]
        rec = {"max_abs_err": float((loops[name]["out"] - want).abs().max()),
               "iters": iters, "ms": loops[name]["ms"],
               "ns_per_iter": loops[name]["ns_per_iter"], "plain_ms": plain_ms,
               "bound_ms": iters * chain / (cur * 1e6) * 1e3,
               "bound_by": "operations", "chain_cycles_per_iter": chain,
               "sm_clock_mhz": cur, "sm_clock_max_mhz": top}
        print(f"X3 {fn.__name__}: ok={ok} {rec['ms']:.3f} ms "
              f"({rec['ns_per_iter']:.3f} ns/iter), plain {plain_ms:.1f} ms, "
              f"bound {rec['bound_ms']:.3f} ms ({chain} cycles/iter at "
              f"{cur:.0f} MHz, max {top:.0f})")
        ok_all &= ok
        records[fn.__name__] = rec
    return ok_all, records


def run_experiments(dev, world_path):
    """Phase 15 on plate-2048 and the World scene: the measurement entry
    points, counts set to 0 just before and read just after, then each of
    their kernels against its plain version. Returns (records, launches
    of the phase's kernels)."""
    from prosper_tpu_torch.experiments import bench_mxu_isect as bmi
    from prosper_tpu_torch.scripts import bench_loop_overhead as blo
    from prosper_tpu_torch.scripts import bench_visit_breakdown as bvb

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    visits = {"plate": bvb.main("plate", dev),
              "world": bvb.main(world_path, dev)}
    mxu = bmi.main(dev)
    loops = blo.main(dev)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts[k] for k in EXPERIMENT_PATH}
    print(f"phase 15 entry points: {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"phase 15: kernels never launched: {missing}")

    ok_all, records = True, {}
    for label, (rec, t) in visits.items():
        for name, (ok, r) in (
                ("walk_leaves", check_walk(label, t["table"], t["rays"], rec)),
                ("trace_closest_bvh_visits",
                 check_visits(label, t["scene"], t["rays"], t["rows"], rec)),
                ("moller_chain_loop", check_moller_unit(label, t, rec))):
            ok_all &= ok
            if name in records:  # the plate set leads, the World's beside
                records[name]["world"] = r
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], r["max_abs_err"])
            else:
                records[name] = r
    ok, r = check_isect_loops(mxu, dev)
    ok_all &= ok
    records.update(r)
    ok, r = check_probes(loops, dev)
    ok_all &= ok
    records.update(r)
    if not ok_all:
        raise RuntimeError("phase 15: a kernel disagrees with its plain "
                           "version")
    return records, launches


def run_world(smi, dev):
    """Phases 13-15; returns (records of K11-K13 and of phase 15's
    kernels, launches per kernel over the two World frames and phase 15's
    entry points, {where: {kernel: record}} of K1-K4 on the World's
    rays)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    try:
        phase("world")
        path, _, times = load_world(tmp)
        launches, (fn, scene, cam), world = run_world_frames(
            smi, dev, path, tmp)
        phase("kernels: 8-wide")
        ok, records, k4 = check_bvh8_kernels(smi, scene, cam)
        world["world_primary"] = {"trace_closest_bvh_full": k4}
        if not ok:
            raise RuntimeError("an 8-wide kernel disagrees with its plain "
                               "version or with its BVH2 twin")
        records["trace_closest_bvh8"]["world_load"] = times
        phase("kernels: experiments")
        t0 = time.perf_counter()
        exp_records, exp_launches = run_experiments(dev, path)
        print(f"experiments phase: {time.perf_counter() - t0:.1f} s; card: "
              f"{smi}")
        records.update(exp_records)
        launches.update(exp_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records, launches, world


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    phase("device")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"])
    from prosper_tpu_torch.ops import cuda_build

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    print(sh([cuda_build.find_nvcc(), "--version"]).splitlines()[-1])
    print(f"card: {smi}")

    phase("build")
    t0 = time.perf_counter()
    each = cuda_build.build_all()
    print(f"build_s {time.perf_counter() - t0:.2f} (" + ", ".join(
        f"{k} {s:.2f}" for k, s in each.items()) + ")")
    for name in cuda_build.SOURCES:
        print(cuda_build.build_log(name).strip())
    # K1-K4's warp walk beside X3a's one-thread walk
    print("ptxas: " + " | ".join(
        ptxas_line(cuda_build.build_log("trace_bvh"), sym)
        for sym in PTXAS_KERNELS))

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    pt_records, pt_launches = run_pt(smi, dev)
    print(f"pt phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records, launches = run_deferred(smi, dev)
    print(f"deferred phases: {time.perf_counter() - t0:.1f} s")

    # K1 serves both paths: its path tracer form leads its record
    k1 = records.pop("trace_primary_bvh_full")
    pt_records["trace_primary_bvh_full"].update(
        {f"gbuffer_{k}": v for k, v in k1.items()})
    pt_records["trace_primary_bvh_full"]["max_abs_err"] = max(
        k1["max_abs_err"], pt_records["trace_primary_bvh_full"]["max_abs_err"])
    records = {**pt_records, **records}
    t0 = time.perf_counter()
    flat_records, fwd_launches = run_forward(smi, dev, records)
    print(f"forward phases: {time.perf_counter() - t0:.1f} s")
    records.update(flat_records)
    t0 = time.perf_counter()
    any_records, k3_restir, restir_launches = run_restir(smi, dev)
    print(f"restir phases: {time.perf_counter() - t0:.1f} s")
    records.update(any_records)
    records["trace_any_bvh"]["restir_shadow_set"] = {k: k3_restir[k] for k in (
        "rays", "live_rays", "occluded", "ms", "plain_ms", "bound_ms",
        "bound_by")}
    t0 = time.perf_counter()
    pt_flat_launches = run_pt_flat(smi, dev, records)
    print(f"pt bvh=False phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_records, lm_launches = run_leafmajor(smi, dev)
    print(f"leafmajor phases: {time.perf_counter() - t0:.1f} s")
    records.update(lm_records)
    t0 = time.perf_counter()
    world_records, world_launches, world = run_world(smi, dev)
    print(f"world phases: {time.perf_counter() - t0:.1f} s")
    records.update(world_records)
    for where, recs in world.items():  # K1-K4 on the World's rays
        for name, rec in recs.items():
            records[name][where] = rec
            records[name]["max_abs_err"] = max(
                records[name]["max_abs_err"], rec.get("max_abs_err", 0.0))
    for counts in (pt_launches, fwd_launches, restir_launches,
                   pt_flat_launches, lm_launches, world_launches):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    kernels = []
    for name, rec in records.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": replaces, "launches": launches.get(name, 0),
            "library_ms": None, **rec,
        })
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
