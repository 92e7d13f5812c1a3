"""Where a bounce ray's K2 time goes: leaf visits per ray and the Möller
unit, on the card.

    python -m prosper_tpu_torch.scripts.bench_visit_breakdown [scene]

Counterpart of scripts/bench_visit_breakdown.py, which counted K2's leaf
visits per 256-ray packet (DEBUG_VISITS), timed K2 and a loop of 1024
chained Möller blocks on FlightHelmet's bounce rays. That asset is not
in the repo; `main(scene)` runs on "plate" (testing.make_plate_scene,
2048 clusters) or a .gltf/.glb path (testing.write_plate_gltf writes the
plate scene as one), at 1920x1080:

1. primary rays: the 1080p pinhole rays in 16x16 block order, traced by
   K4; `bounce_rays` makes the script's cosine bounce set from the hits
   (:66-115), sorted by cluster and direction octant;
2. X3a: K2 with per-ray counts (`trace_closest_bvh_visits`): the leaves
   each ray tests and the interior nodes it expands, as mean, max,
   percentiles and total; K2's time on the same rays;
3. X1: the per-ray threaded walk (`walk_leaves`, max_leaf_size=1 BVH over
   the same leaf boxes) counts the leaves each ray enters before its K2
   hit t (the visits no walk can skip) and before its t_max (every leaf
   a walk could visit);
4. X3b: the Möller unit, `moller_chain_loop` over one cluster's slab: ns
   per (ray, 128-triangle) visit on the first 256 rays (K = 1024, the
   script's) and on the whole set (K = 32), and the estimated Möller
   share of K2, unit x total visits (:210-211). The unit runs X2's loop
   (four lanes a ray, 1 / det without a branch) while K2 tests a leaf
   with 32 lanes on one ray and IEEE division, so the estimate is the
   Möller share of K2 with a branch-free reciprocal, not with K2's own
   division.

Times are CUDA events on the card; on a CPU device the plain versions
run and no time is taken.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..experiments import trace_wavefront as tw
from ..ops import bench_kernels as bk
from ..ops import trace as ttrace
from ..ops import trace_bvh as tb
from ..ops.rays import pinhole_rays

WIDTH, HEIGHT = 1920, 1080
T_MIN = 1e-4  # what the Pallas kernels hard-code for closest hits
K_UNIT = 1024  # chained Möller blocks on 256 rays (the script's K)
K_SET = 32  # chained Möller blocks on the whole bounce set
LANES = 128


def bounce_rays(o, d, rows):
    """scripts/bench_visit_breakdown.py:66-115 (and bench_bvh8.py:82-128)
    on the port's tensors: from every hit of the primary rows (R, 16), a
    cosine-distributed direction about its normal (numpy default_rng(0)),
    the origin 1e-4 along the normal; padded with dead rays (t_max 0) to
    a multiple of 2048 and sorted by (cluster, octant of the direction).
    Returns (o, d, t_max, live rays)."""
    t = rows[:, 0].cpu().numpy()
    tri = rows[:, 1].cpu().numpy().astype(np.int64)
    n = rows[:, 2:5].cpu().numpy()
    pos = o.cpu().numpy() + t[:, None] * d.cpu().numpy()
    idx = np.nonzero(tri >= 0)[0]
    rng = np.random.default_rng(0)
    nrm = n[idx]
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    u1, u2 = rng.random(idx.size), rng.random(idx.size)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    tang = np.cross(nrm, np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0, 0]],
                                  [[0, 1.0, 0]]))
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-9)
    bit = np.cross(nrm, tang)
    dd = (tang * (r * np.cos(phi))[:, None] + bit * (r * np.sin(phi))[:, None]
          + nrm * np.sqrt(np.maximum(1 - u1, 0))[:, None]).astype(np.float32)
    oo = (pos[idx] + 1e-4 * nrm).astype(np.float32)
    cluster = tri[idx] // LANES
    pad = (-idx.size) % 2048
    oo = np.pad(oo, ((0, pad), (0, 0)))
    dd = np.pad(dd, ((0, pad), (0, 0)))
    tmax = np.pad(np.full(idx.size, np.inf, np.float32), (0, pad))
    cl = np.pad(cluster, (0, pad))
    ad = np.abs(dd)
    denom = np.maximum(ad.sum(1), 1e-20)
    ox, oy = dd[:, 0] / denom, dd[:, 1] / denom
    fold = dd[:, 2] < 0
    ox2 = np.where(fold, (1 - np.abs(oy)) * np.sign(ox), ox)
    oy2 = np.where(fold, (1 - np.abs(ox)) * np.sign(oy), oy)
    bx = np.clip(((ox2 * 0.5 + 0.5) * 8).astype(np.int32), 0, 7)
    by = np.clip(((oy2 * 0.5 + 0.5) * 8).astype(np.int32), 0, 7)
    perm = np.argsort(cl * 128 + (bx * 8 + by) * 2 + fold, kind="stable")
    dev = o.device
    return (torch.as_tensor(oo[perm], device=dev),
            torch.as_tensor(dd[perm], device=dev),
            torch.as_tensor(tmax[perm], device=dev), idx.size)


def primary_rays(cam, width, height, device):
    """The pinhole rays through the pixel centres in 16x16 block order."""
    px, py, _ = ttrace.block_pixel_order(width, height)
    uv = (torch.as_tensor(np.stack([px, py], -1).astype(np.float32),
                          device=device) + 0.5) / torch.tensor(
        [float(width), float(height)], device=device)
    o, d = pinhole_rays(cam, uv)
    return o.contiguous(), d.contiguous()


def stats(x: torch.Tensor, live: torch.Tensor) -> dict:
    """mean, max, p50/p90/p99 and total of a per-ray count over the live
    rays."""
    v = x[live].double()
    q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                       device=v.device)).tolist()
    return {"mean": float(v.mean()), "max": float(v.max()), "p50": q[0],
            "p90": q[1], "p99": q[2], "total": float(v.sum())}


def threaded_table(scene_arrays):
    """pack_threaded over a max_leaf_size=1 BVH of the scene's leaf boxes
    (the cluster AABBs K2's leaves hold)."""
    geom, frame = scene_arrays["geom"], scene_arrays["frame"]
    cmin, cmax = tb._leaf_boxes(frame["bvh_bounds"], frame["bvh_meta"],
                                geom["packed9"].shape[0])
    bvh = build_bvh(cmin.cpu().numpy(), cmax.cpu().numpy(), max_leaf_size=1)
    return torch.as_tensor(tw.pack_threaded(bvh),
                           device=frame["bvh_bounds"].device)


def _time(fn, device, reps=3):
    if torch.device(device).type != "cuda":
        return None
    return bk.event_ms(fn, reps)


def breakdown(scene_arrays, cam, width=WIDTH, height=HEIGHT):
    """Steps 1-4 on one scene -> a record (counts, times in ms or None)
    and the tensors behind it ("scene": scene_arrays, "rays": (o, d,
    t_max), "rows": the counting K2's rows, "table": the threaded
    table, "unit_slab" and "unit_best": the Möller unit's slab and the
    best of each of its runs)."""
    geom, frame = scene_arrays["geom"], scene_arrays["frame"]
    dev = geom["packed9"].device
    p40, p9 = geom["packed_full"], geom["packed9"]
    bvh = (frame["bvh_bounds"], frame["bvh_meta"])
    o, d = primary_rays(cam, width, height, dev)
    inf = torch.full((o.shape[0],), float("inf"), device=dev)
    primary = tb.trace_closest_bvh_full(p40, *bvh, o, d, T_MIN, inf)
    tb.check_stack_overflow(dev)
    ob, db, tmax, n_live = bounce_rays(o, d, primary)
    live = tmax > 0
    rec = {"rays": int(ob.shape[0]), "live_rays": int(n_live)}

    rows = tb.trace_closest_bvh_visits(p9, *bvh, ob, db, T_MIN, tmax)
    tb.check_stack_overflow(dev)
    rec["leaf_visits"] = stats(rows[:, 7], live)
    rec["node_pops"] = stats(rows[:, 6], live)
    rec["hits"] = int((rows[:, 1] >= 0).sum())
    rec["k2_ms"] = _time(lambda: tb.trace_closest_bvh(p9, *bvh, ob, db, T_MIN,
                                                      tmax), dev)
    rec["visits_kernel_ms"] = _time(lambda: tb.trace_closest_bvh_visits(
        p9, *bvh, ob, db, T_MIN, tmax), dev)

    table = threaded_table(scene_arrays)
    hit_t = torch.where(rows[:, 1] >= 0, rows[:, 0], tmax)
    _, needed = tw.walk_leaves(table, ob, db, hit_t)
    _, entered = tw.walk_leaves(table, ob, db, tmax)
    rec["leaves_before_hit"] = stats(needed, live)
    rec["leaves_entered"] = stats(entered, live)
    rec["walk_ms"] = _time(lambda: tw.walk_leaves(table, ob, db, tmax), dev)

    slab = p9[0, 0:9].contiguous()
    cols = bk.cols_from_rays(ob, db)
    unit, unit_best = {}, {}
    for label, c, k in (("256_rays", cols[0:1], K_UNIT), ("set", cols, K_SET)):
        unit_best[label], _ = bk.moller_chain_loop(slab, c, k)
        ms = _time(lambda: bk.moller_chain_loop(slab, c, k), dev)
        unit[label] = {"rays": c.shape[0] * bk.TILE, "k": k, "ms": ms,
                       "ns_per_ray_visit": None if ms is None
                       else ms * 1e6 / (k * c.shape[0] * bk.TILE)}
    rec["moller_unit"] = unit
    ns = unit["set"]["ns_per_ray_visit"]
    rec["est_moller_share_ms"] = (None if ns is None else
                                  ns * rec["leaf_visits"]["total"] * 1e-6)
    return rec, {"scene": scene_arrays, "rays": (ob, db, tmax), "rows": rows,
                 "table": table, "unit_slab": slab, "unit_best": unit_best}


def report(label, rec) -> None:
    def line(name, s):
        return (f"{name}: mean {s['mean']:.2f} max {s['max']:.0f} p50 "
                f"{s['p50']:.0f} p90 {s['p90']:.0f} p99 {s['p99']:.0f} total "
                f"{s['total']:.0f}")

    def ms(x):
        return "not measured" if x is None else f"{x:.3f} ms"

    print(f"{label}: {rec['live_rays']} live bounce rays of {rec['rays']}, "
          f"{rec['hits']} hits")
    print("  " + line("K2 leaf visits/ray", rec["leaf_visits"]))
    print("  " + line("K2 interior nodes/ray", rec["node_pops"]))
    print("  " + line("leaves entered before the hit/ray",
                      rec["leaves_before_hit"]))
    print("  " + line("leaves entered before t_max/ray",
                      rec["leaves_entered"]))
    print(f"  K2 {ms(rec['k2_ms'])}, counting K2 "
          f"{ms(rec['visits_kernel_ms'])}, threaded walk {ms(rec['walk_ms'])}")
    for k, u in rec["moller_unit"].items():
        per = ("not measured" if u["ns_per_ray_visit"] is None
               else f"{u['ns_per_ray_visit']:.4f} ns")
        print(f"  moller unit ({k}, {u['rays']} rays, K={u['k']}): {per} per "
              f"(ray, 128-triangle) visit")
    print(f"  est moller share of K2: {ms(rec['est_moller_share_ms'])}")


def main(scene: str = "plate", device="cuda", width=WIDTH, height=HEIGHT):
    """Build the scene through entry() and run `breakdown` on it; prints
    the report and returns what `breakdown` returns."""
    from ..entry import entry

    _, (scene_arrays, cam, _) = entry(device, scene=scene, n_clusters=2048,
                                      width=width, height=height)
    rec, tensors = breakdown(scene_arrays, cam, width, height)
    if torch.device(device).type == "cuda":
        print(f"card: {torch.cuda.get_device_name(0)}")
    report(scene, rec)
    return rec, tensors


if __name__ == "__main__":
    main(*sys.argv[1:2])
