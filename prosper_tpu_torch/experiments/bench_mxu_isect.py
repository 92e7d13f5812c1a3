"""X2 on the card: ray-triangle blocks, FMA Möller against tensor-core
Plücker.

    python -m prosper_tpu_torch.experiments.bench_mxu_isect

Counterpart of experiments/bench_mxu_isect.py: on its seeded scene (128
triangles in a unit box, 256 rays through it, default_rng(0)) it first
holds the Plücker block against the Möller block (hit agreement above
99.95%, the script's bar), then loops each block NV = 2000 times, chained
(ops/bench_kernels.py), and reports ms and us per visit (one visit = one
256-ray x 128-triangle block). `run(variant, blocks=1)` is the script's
figure, one block, a latency; `blocks` a multiple of the SM count gives
the card's throughput, which answers FMA against tensor cores, over
`block_cols`' distinct rays. Times are CUDA events on the card; on a CPU
device the loops run their plain versions and no time is taken.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bench_kernels as bk
from ..ops.plucker import plucker_rows_from_slab

TILE = bk.TILE
NV = 2000
VARIANTS = ("moller", "plucker", "plucker_pre")
AGREEMENT = 0.9995  # bench_mxu_isect.py:89


def scene(device):
    """The script's triangles and rays (:49-58) -> (slab (9, 128), o, d
    (256, 3)), float32 on device."""
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    e1 = rng.uniform(-0.6, 0.6, (128, 3)).astype(np.float32)
    e2 = rng.uniform(-0.6, 0.6, (128, 3)).astype(np.float32)
    slab = np.ascontiguousarray(np.concatenate([v0.T, e1.T, e2.T], axis=0))
    o = rng.uniform(-3, 3, (TILE, 3)).astype(np.float32)
    d = rng.normal(size=(TILE, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.as_tensor(a, device=device) for a in (slab, o, d))


def block_cols(blocks: int, device):
    """The script's scene with `blocks` blocks of rays -> (slab, cols
    (blocks, 6, 256)): block 0 holds the script's 256 rays, the others
    rays drawn the same way from default_rng(1), so that every block
    tests different pairs."""
    slab, o, d = scene(device)
    rng = np.random.default_rng(1)
    n = TILE * (blocks - 1)
    o2 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = torch.cat([o, torch.as_tensor(o2, device=device)])
    d = torch.cat([d, torch.as_tensor(d2, device=device)])
    return slab, bk.cols_from_rays(o, d)


def loop_input(variant, slab):
    """What a variant's loop takes: the 22 feature rows for plucker_pre,
    else the 9-row slab."""
    if variant == "plucker_pre":
        return plucker_rows_from_slab(slab).contiguous()
    return slab


LOOPS = {"moller": bk.isect_loop_moller, "plucker": bk.isect_loop_plucker,
         "plucker_pre": bk.isect_loop_plucker_pre}


def agreement(t_ref, t):
    """(share of pairs with the same hit/miss, max relative t error where
    both hit) of two (R, 128) t blocks, inf on a miss."""
    h0, h1 = torch.isfinite(t_ref), torch.isfinite(t)
    both = h0 & h1
    rel = torch.where(both, (t_ref - t).abs()
                      / torch.clamp_min(t_ref.abs(), 1e-6), 0.0)
    return float((h0 == h1).float().mean()), float(rel.max())


def check(device="cuda"):
    """One Möller block and one tensor-core Plücker block (the loops at
    one iteration) on the script's scene; asserts hit agreement above
    99.95% and returns (agreement, max t relative error, hits of each)."""
    slab, o, d = scene(device)
    cols = bk.cols_from_rays(o, d)
    _, t0 = bk.isect_loop_moller(slab, cols, 1, keep_t=True)
    _, t1 = bk.isect_loop_plucker(slab, cols, 1, keep_t=True)
    agree, terr = agreement(t0, t1)
    h0, h1 = int(torch.isfinite(t0).sum()), int(torch.isfinite(t1).sum())
    print(f"hit agreement: {agree * 100:.3f}%  (moller {h0} hits, "
          f"plucker {h1})")
    print(f"t rel err max {terr:.2e}")
    assert agree > AGREEMENT, "plucker disagrees with moller"
    return {"agreement": agree, "t_rel_err": terr, "moller_hits": h0,
            "plucker_hits": h1}


def run(variant: str, blocks: int = 1, device="cuda", iters: int = NV):
    """Loop one variant `iters` times over `block_cols(blocks)` ->
    {"variant", "blocks", "iters", "ms", "us_per_visit", "best"}: ms per
    call, us per 256 x 128 block visit (per block, so a throughput at
    blocks > 1), None where the device is not a card; best the loop's
    output."""
    slab, c = block_cols(blocks, device)
    a = loop_input(variant, slab)
    fn = LOOPS[variant]
    best, _ = fn(a, c, iters)
    rec = {"variant": variant, "blocks": blocks, "iters": iters, "ms": None,
           "us_per_visit": None, "best": best}
    if torch.device(device).type != "cuda":
        return rec
    ms = bk.event_ms(lambda: fn(a, c, iters))
    rec["ms"] = ms
    rec["us_per_visit"] = ms * 1e3 / (iters * blocks)
    return rec


def main(device="cuda"):
    """check(), then each variant at one block and at full card (8 blocks
    per SM; 2 blocks on a CPU device); returns the records."""
    out = {"check": check(device), "runs": []}
    full_blocks = 2
    if torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(device)
        full_blocks = 8 * props.multi_processor_count
    for blocks in (1, full_blocks):
        for variant in VARIANTS:
            rec = run(variant, blocks, device)
            out["runs"].append(rec)
            if rec["ms"] is None:
                print(f"{variant:12s} x{blocks}: not measured (no card)")
            else:
                print(f"{variant:12s} x{blocks}: {rec['ms']:8.2f} ms  "
                      f"({rec['us_per_visit']:6.3f} us/visit)")
    return out


if __name__ == "__main__":
    main()
