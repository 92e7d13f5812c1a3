"""BVH trace kernels: wrappers, plain PyTorch versions, camera uniforms.

Counterpart of prosper_tpu/ops/trace_bvh.py. Ten kernels, each a
hand-written CUDA kernel in csrc/trace_bvh.cu with a plain PyTorch twin:

- `trace_primary_bvh_full` (K1, replaces the Pallas kernel of the same
  name, trace_bvh.py:1431): pinhole primary rays generated from pixel
  layouts + `primary_cam_vec` uniforms — the path tracer's per-pixel pcg
  jitter or the G-buffer's pixel centres shifted by the TAA jitter —
  closest hit, attributes at the final hit -> (T*256, 16) rows.
- `trace_closest_bvh` (K2, trace_bvh.py:1050): closest hit -> (R, 8) rows.
  K1-K4 walk one ray per lane and test each leaf with the whole warp
  (csrc/trace_bvh.cu warp_walk); their rows equal the lockstep plain
  walk's (trace_closest_bvh_visits_plain; K1's and K4's through
  _full_rows, K4's under its skip mask) bit for bit.
- `trace_closest_bvh_visits` (X3a, K2's body under DEBUG_VISITS,
  scripts/bench_visit_breakdown.py:148): K2's rows with the interior
  nodes each ray expands in row 6 and the leaves it tests in row 7, on
  K2's own warp walk (warp_closest_kernel<true>), so rows 0-5 are K2's.
  Its plain version walks the BVH as the kernels do, so the counts
  agree.
- `trace_closest_bvh_full` (K4, trace_bvh.py:1211): closest hit of given
  rays with an optional per-cluster `skip_mask` (the two-phase meshlet
  cull's draw list) and attributes at the final hit -> (R, 16) rows.
- `trace_any_bvh` (K3, trace_bvh.py:1768): any hit -> (R,) bool.
- `trace_any_bvh_dense` (K10, trace_bvh.py:1809): K3's any hit through
  a dense cull instead of the stack walk: each 128-ray packet tests
  every cluster's leaf box, then each ray tests the listed clusters'
  leaf boxes and triangles -> (R,) bool; an optional `skip_mask` as
  K4's. The policy config.policy.any_tracer = "dense" selects it
  (ops/trace.make_tracer).
- `trace_closest_bvh_dense` (K9, trace_bvh.py:1144): K2's closest hit
  through K10's dense cull -> (R, 8) rows, with K10's `skip_mask`; its
  walk is K10's (each listed cluster's owners tested by the whole warp)
  with the closest-hit leaf test, so its rows equal its plain version's
  bit for bit. No frame calls it, in the JAX package either;
  chip_smoke.py checks it and prints `dense_walk_counts` (plain
  PyTorch, for measurement only: the clusters K9's walk tests per ray
  and per warp).
- `dense_cull_counts`: K10's measurement form (csrc/trace_bvh.cu
  `dense_cull_kernel`, which chip_smoke.py alone calls; no frame selects
  it): the dense cull alone -> (ceil(R / 128),) i32, each packet's list
  length, so that the cull and K10's walk are timed apart.

Dispatch: a wrapper runs the plain version only because its tensors lie
on the CPU. On CUDA tensors it launches the kernel or raises; it never
falls back. Each wrapper counts its kernel launches in `.launches`.
A ray that overflows its node stack sets a per-device flag, which
`check_stack_overflow` turns into an exception (once per frame in
render/pt.py), so no node is dropped silently.

t_min: the Pallas kernels ignore their t_min argument (1e-4 closest, 0.1
any-hit, trace_bvh.py:675/:1633); these kernels and plain versions
honour it, as the XLA tracer in prosper_tpu/ops/trace.py does.

The plain versions but X3a's are brute force over the cluster slabs,
chunked by rays: a per-ray slab test against every live cluster's AABB
(the BVH's leaf boxes; K4 drops the masked clusters first) picks (ray,
cluster) pairs, Möller runs on all 128 triangles of each pair, and a
per-ray reduction keeps the nearest hit (lowest tri id among exact
ties). They share no traversal with the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..mathx import rng as prng
from ..utils.profiler import gprofiler
from .intersect import moller_trumbore, safe_inv_dir, slab_enter_exit
from .slabs import ROWS_FULL, ROWS_PLAIN
from .trace import CLUSTER_PAD, TILE

STACK_CAP = 64  # per-ray node stack of the CUDA kernels (trace_bvh.py:52)
# per-ray stack of the 8-wide kernels: 7 entries per level plus one
# (accel/bvh.nodes8_depth), so 8-wide depths up to 18
STACK8_CAP = 128
TILES_PER_STEP = 8  # pixel-layout padding unit of pack_pixels_np


# ---------------------------------------------------------------------------
# Host-side layouts


def pack_pixels_np(px, py, tile: int = TILE):
    """numpy pixel coordinates -> the primary kernel's static layout.

    Returns (cols (T, 3, tile) f32 with channels px | py | tmax, R0);
    tmax is inf for real pixels and 0 for the pad up to a multiple of
    TILES_PER_STEP * tile (trace_bvh.py:1272)."""
    R0 = int(px.shape[0])
    pad = (-R0) % (TILES_PER_STEP * tile)
    pxp = np.concatenate(
        [np.asarray(px, np.float32), np.full(pad, -1.0, np.float32)]
    )
    pyp = np.concatenate(
        [np.asarray(py, np.float32), np.full(pad, -1.0, np.float32)]
    )
    tm = np.concatenate(
        [np.full(R0, np.inf, np.float32), np.zeros(pad, np.float32)]
    )
    T = pxp.shape[0] // tile
    cols = np.stack(
        [pxp.reshape(T, tile), pyp.reshape(T, tile), tm.reshape(T, tile)],
        axis=1,
    )
    return cols, R0


def primary_cam_vec(cam: dict, width, height, pixel_jitter=None,
                    device=None, y_offset: int = 0) -> torch.Tensor:
    """(1, 24) f32 camera uniforms of the primary kernel: eye | A | B | C
    | W H offx offy pcg_on | pad, with d = normalize(ux*A + uy*B + C) the
    affine per-pixel form of rays.pinhole_rays and ux = (px + pcg_on*jx
    + offx) / W, uy likewise (trace_bvh.py:1388-1427, :212-214).

    pixel_jitter=None: the path tracer's per-pixel pcg jitter (offx =
    offy = 0, pcg_on = 1). A (2,) NDC jitter (cam["current_jitter"]):
    the G-buffer's pixel centres shifted by the per-frame TAA jitter
    (offx = 0.5 + 0.5*jx*W, offy = 0.5 - 0.5*jy*H + y_offset, pcg_on =
    0). y_offset, in that form only, renders a band of a `height`-tall
    frame starting at that absolute row, with band-local pixel rows in
    the layout (render/distributed.py); `height` is then the full frame
    height. Built on the camera's device without a host-to-device copy
    (each such copy waits for the device) when cam holds its tensors."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    c2c = f32(cam["camera_to_clip"])
    dev = c2c.device

    def const(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    w2c = f32(cam["world_to_camera"])
    aspect = c2c[1, 1] / c2c[0, 0]
    thfy = 1.0 / c2c[1, 1]
    rt = w2c[0, :3] * thfy * aspect
    up2 = w2c[1, :3] * thfy
    fwd = -w2c[2, :3]
    w, h = const(width), const(height)
    if pixel_jitter is None:
        offx, offy, pcg_on = const(0.0), const(0.0), const(1.0)
    else:
        j = f32(pixel_jitter)
        offx = 0.5 + 0.5 * j[0] * w
        offy = 0.5 - 0.5 * j[1] * h + y_offset
        pcg_on = const(0.0)
    tail = torch.cat([torch.stack([w, h, offx, offy, pcg_on]),
                      torch.zeros(7, dtype=torch.float32, device=dev)])
    return torch.cat(
        [f32(cam["eye"]), 2.0 * rt, 2.0 * up2, fwd - rt - up2, tail]
    ).reshape(1, 24)


def _pixel_rays(pix_cols: torch.Tensor, cam_vec: torch.Tensor, jitter):
    """(o, d, t_max) per lane of the (T, 3, 256) pixel layout, with ux =
    (px + pcg_on*jx + offx) / W (jitter None: no jitter term)."""
    px = pix_cols[:, 0, :].reshape(-1)
    py = pix_cols[:, 1, :].reshape(-1)
    tmax = pix_cols[:, 2, :].reshape(-1)
    c = cam_vec[0]
    if jitter is not None:
        px = px + c[16] * jitter[:, 0]
        py = py + c[16] * jitter[:, 1]
    ux = (px + c[14]) / c[12]
    uy = (py + c[15]) / c[13]
    d = ux[:, None] * c[3:6] + uy[:, None] * c[6:9] + c[9:12]
    inv_n = 1.0 / torch.sqrt(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    )
    d = d * inv_n[:, None]
    o = c[0:3].expand(d.shape)
    return o, d, tmax


def raygen_plain(pix_cols: torch.Tensor, cam_vec: torch.Tensor,
                 frame_index: int):
    """The primary kernel's ray generation in PyTorch (_raygen_tile,
    trace_bvh.py:186-226), for uniforms of either form: returns (o, d,
    t_max), each per lane of the (T, 3, 256) pixel layout flattened to
    T*256 rays."""
    px = pix_cols[:, 0, :].reshape(-1)
    py = pix_cols[:, 1, :].reshape(-1)
    st = prng.make_state(px.to(torch.int64), py.to(torch.int64),
                         frame_index)
    _, jitter = prng.rnd2d01(st)
    return _pixel_rays(pix_cols, cam_vec, jitter)


def gbuffer_rays(cam: dict, width: int, height: int,
                 pix_cols: torch.Tensor, device=None, y_offset: int = 0):
    """The G-buffer form's uniforms (pcg_on = 0, the TAA-shifted pixel
    centres of cam["current_jitter"], a band's y_offset: see
    primary_cam_vec) and the rays K1 traces with them: returns (cam_vec,
    o, d, t_max). The rays equal raygen_plain's for these uniforms bit
    for bit (pcg_on * jitter is 0, and px + 0 is px) without the cost of
    the jitter's hash."""
    cam_vec = primary_cam_vec(cam, width, height,
                              pixel_jitter=cam["current_jitter"],
                              device=device, y_offset=y_offset)
    return (cam_vec, *_pixel_rays(pix_cols, cam_vec, None))


# ---------------------------------------------------------------------------
# Plain PyTorch versions


def dense_aux(n_clusters: int, bounds: torch.Tensor, meta: torch.Tensor,
              skip_mask=None):
    """The dense-cull tracer's per-cluster tables (trace_bvh.py
    `_dense_aux`, :1104-1140) -> (node_of (C,) i32, the cluster's BVH
    leaf node (0, the root, for a cluster no leaf holds); leaf boxes
    cmin, cmax (C, 3); dead (C,) bool). A cluster whose skip_mask entry
    is False is dead: never tested, as K4's skip mask (a true entry
    keeps the cluster, :1121-1123). Dead clusters are flagged, not given
    an inverted box, since the per-ray slab test is symmetric in min and
    max and would accept one. Built without a host wait."""
    dev = bounds.device
    leaf = meta[:, 2].long()
    idx = torch.where(leaf >= 0, leaf, n_clusters)  # non-leaves: dropped
    node_of = torch.zeros(n_clusters + 1, dtype=torch.int32, device=dev)
    node_of.scatter_(0, idx, torch.arange(meta.shape[0], dtype=torch.int32,
                                          device=dev))
    node_of = node_of[:n_clusters]
    b = bounds[node_of.long()]
    if skip_mask is None:
        dead = torch.zeros(n_clusters, dtype=torch.bool, device=dev)
    else:
        dead = ~skip_mask.to(device=dev, dtype=torch.bool)
    return node_of, b[:, 0:3], b[:, 3:6], dead


def _leaf_boxes(bounds: torch.Tensor, meta: torch.Tensor, n_clusters: int):
    """Cluster AABBs (C, 3) x 2 from the BVH's leaf nodes."""
    _, cmin, cmax, _ = dense_aux(n_clusters, bounds, meta)
    return cmin, cmax


def _chunks(device: torch.device):
    """(rays per cull chunk, (ray, cluster) pairs per Möller chunk)."""
    return (4096, 4096) if device.type == "cpu" else (16384, 32768)


def _brute(slabs, cmin, cmax, ray_o, ray_d, t_min, t_max, any_hit,
           live=None, tile_ok=None):
    """Shared brute force over the cluster boxes (cmin, cmax) (C, 3):
    returns (best_t, best_tri, best_u, best_v) per ray, best_t = +inf and
    tri = -1 without a hit (t_min < t < t_max). any_hit=True skips the
    argmin bookkeeping. live (C,) bool drops the clusters it marks False
    before the AABB cull; tile_ok (T, C) bool, with ray r in tile r //
    256, drops the clusters a ray's tile does not list."""
    dev = ray_o.device
    R = ray_o.shape[0]
    inv = safe_inv_dir(ray_d)
    best_t = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    lanes = torch.arange(CLUSTER_PAD, device=dev)
    big = torch.iinfo(torch.int64).max
    ray_chunk, pair_chunk = _chunks(dev)
    for r0 in range(0, R, ray_chunk):
        r1 = min(R, r0 + ray_chunk)
        enter, exit_ = slab_enter_exit(
            ray_o[r0:r1, None, :], inv[r0:r1, None, :], cmin[None], cmax[None]
        )
        ok = (enter <= exit_) & (enter < t_max[r0:r1, None])
        if live is not None:
            ok = ok & live[None, :]
        if tile_ok is not None:
            ok = ok & tile_ok[torch.arange(r0, r1, device=dev) // TILE]
        ri, ci = torch.nonzero(ok, as_tuple=True)  # ri local to the chunk
        bt = best_t[r0:r1]
        btri = best_tri[r0:r1]
        for p0 in range(0, ri.shape[0], pair_chunk):
            rl = ri[p0:p0 + pair_chunk]
            r = rl + r0
            c = ci[p0:p0 + pair_chunk]
            s = slabs[c, 0:ROWS_PLAIN, :]  # (P, 9, 128)
            hit, t, u, v = moller_trumbore(
                ray_o[r][:, None, :], ray_d[r][:, None, :],
                s[:, 0:3].transpose(1, 2), s[:, 3:6].transpose(1, 2),
                s[:, 6:9].transpose(1, 2), t_min, t_max[r][:, None],
            )
            t = torch.where(hit, t, float("inf"))
            tp = t.min(dim=1).values  # nearest hit of each pair
            if any_hit:
                bt.scatter_reduce_(0, rl, tp, reduce="amin")
                continue
            lane = torch.where(t == tp[:, None], lanes, CLUSTER_PAD).amin(1)
            lane = torch.clamp_max(lane, CLUSTER_PAD - 1)
            tri = c * CLUSTER_PAD + lane
            # this chunk's best (t, tri) per ray, lexicographic
            ct = torch.full_like(bt, float("inf"))
            ct.scatter_reduce_(0, rl, tp, reduce="amin")
            win = torch.isfinite(tp) & (tp == ct[rl])
            ctri = torch.full_like(btri, big)
            ctri.scatter_reduce_(0, rl, torch.where(win, tri, big),
                                 reduce="amin")
            # merge with the running best of earlier chunks
            take = torch.isfinite(ct) & (
                (ct < bt) | ((ct == bt) & (ctri < btri))
            )
            pick = win & (tri == ctri[rl]) & take[rl]
            rows, sel = rl[pick], lane[pick]
            best_u[r0 + rows] = u[pick, sel]
            best_v[r0 + rows] = v[pick, sel]
            bt.copy_(torch.where(take, ct, bt))
            btri.copy_(torch.where(take, ctri, btri))
    return best_t, best_tri, best_u, best_v


def _closest_rows(slabs, cmin, cmax, ray_o, ray_d, t_min, t_max,
                  live=None, tile_ok=None):
    """(R, 8) closest-hit rows t | tri | u | v | 0 0 0 0 over the cluster
    boxes (cmin, cmax)."""
    best_t, tri, u, v = _brute(
        slabs, cmin, cmax, ray_o, ray_d, t_min, t_max, False, live, tile_ok
    )
    hit = tri >= 0
    out = torch.zeros((ray_o.shape[0], 8), dtype=torch.float32,
                      device=ray_o.device)
    out[:, 0] = torch.where(hit, best_t, t_max)
    out[:, 1] = tri.to(torch.float32)
    out[:, 2] = torch.where(hit, u, 0.0)
    out[:, 3] = torch.where(hit, v, 0.0)
    return out


def _full_rows(slabs, h8):
    """(R, 8) closest-hit rows -> (R, 16) full rows: the attributes of
    the hit triangle, interpolated as the kernels' write_full does
    (slabs.attrs_from_hit_rows); zero attributes on a miss."""
    tri = h8[:, 1].to(torch.int64)
    miss = tri < 0
    tri = torch.clamp_min(tri, 0)
    a = slabs[tri // CLUSTER_PAD, ROWS_PLAIN:38, tri % CLUSTER_PAD]  # (R, 29)
    u = h8[:, 2:3]
    v = h8[:, 3:4]
    w = 1.0 - u - v
    normal = w * a[:, 0:3] + u * a[:, 3:6] + v * a[:, 6:9]
    tangent = w * a[:, 9:13] + u * a[:, 13:17] + v * a[:, 17:21]
    uv = w * a[:, 21:23] + u * a[:, 23:25] + v * a[:, 25:27]
    attrs = torch.cat([normal, tangent, uv, a[:, 27:29]], dim=1)
    out = torch.zeros((h8.shape[0], 16), dtype=torch.float32,
                      device=h8.device)
    out[:, 0:2] = h8[:, 0:2]
    out[:, 2:13] = torch.where(miss[:, None], 0.0, attrs)
    return out


def trace_closest_bvh_plain(slabs, bounds, meta, ray_o, ray_d, t_min, t_max):
    """Plain closest hit -> (R, 8) rows t | tri | u | v | 0 0 0 0."""
    return _closest_rows(slabs, *_leaf_boxes(bounds, meta, slabs.shape[0]),
                         ray_o, ray_d, t_min, t_max)


def trace_closest_bvh_visits_plain(slabs, bounds, meta, ray_o, ray_d, t_min,
                                   t_max, skip_mask=None):
    """Plain X3a -> K2's (R, 8) rows with row 6 = interior nodes the ray
    expands and row 7 = leaves it tests.

    Unlike K2's plain version this one walks the BVH as the kernels do
    (csrc/trace_bvh.cu warp_walk, per lane), every ray in lockstep: the
    root test, a pop per step, the prune of an entry >= the best t, a
    leaf's Möller over its 128 lanes with a strict t < best (the lowest
    lane among equal t), an interior node's two children tested against
    the best t and pushed far first (ties to the left child), a stack of
    STACK_CAP entries. So its counts equal X3a's and its rows K1's,
    K2's and K4's, ties included: the independent twin those kernels are
    held to. skip_mask (C,) bool: a popped leaf whose cluster is marked
    False is dropped unread and uncounted, as K4 drops it. A ray that
    would overflow the stack raises."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = t_max.to(dev, torch.float32).expand(R)
    inv = safe_inv_dir(ray_d)
    best = t_max.clone()
    tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    counts = torch.zeros((R, 2), dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK_CAP), dtype=torch.int32, device=dev)
    stack_enter = torch.zeros((R, STACK_CAP), dtype=torch.float32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    lanes = torch.arange(CLUSTER_PAD, device=dev)
    bmin, bmax = bounds[:, 0:3], bounds[:, 3:6]
    if skip_mask is not None:
        skip_mask = skip_mask.to(device=dev, dtype=torch.bool)

    def test(a, node):
        en, ex = slab_enter_exit(ray_o[a], inv[a], bmin[node], bmax[node])
        return (en <= ex) & (en < best[a]), en

    def push(a, node, enter):
        stack[a, sp[a]] = node.to(torch.int32)
        stack_enter[a, sp[a]] = enter
        sp[a] += 1

    live = torch.nonzero(best > 0.0).flatten()
    root = torch.zeros_like(live)
    ok, en = test(live, root)
    push(live[ok], root[ok], en[ok])
    walking = live[ok]
    _, pair_chunk = _chunks(dev)
    while walking.numel():
        sp[walking] -= 1
        node = stack[walking, sp[walking]].long()
        keep = stack_enter[walking, sp[walking]] < best[walking]
        a, node = walking[keep], node[keep]
        leaf = meta[node, 2].long()
        is_leaf = leaf >= 0
        if skip_mask is not None:  # a dead leaf: neither tested nor expanded
            live_leaf = is_leaf & skip_mask[leaf.clamp_min(0)]
            keep = live_leaf | ~is_leaf
            a, node = a[keep], node[keep]
            leaf, is_leaf = leaf[keep], live_leaf[keep]
        for r0 in range(0, int(is_leaf.sum()), pair_chunk):
            rl = a[is_leaf][r0:r0 + pair_chunk]
            c = leaf[is_leaf][r0:r0 + pair_chunk]
            counts[rl, 1] += 1
            s = slabs[c, 0:ROWS_PLAIN, :]
            hit, t, u, v = moller_trumbore(
                ray_o[rl][:, None, :], ray_d[rl][:, None, :],
                s[:, 0:3].transpose(1, 2), s[:, 3:6].transpose(1, 2),
                s[:, 6:9].transpose(1, 2), t_min, best[rl][:, None])
            t = torch.where(hit, t, float("inf"))
            tmin = t.min(dim=1).values
            lane = torch.where(t == tmin[:, None], lanes, CLUSTER_PAD).amin(1)
            imp = torch.isfinite(tmin)
            rows, lane = rl[imp], lane[imp]
            best[rows] = tmin[imp]
            tri[rows] = c[imp] * CLUSTER_PAD + lane
            best_u[rows] = u[imp, lane]
            best_v[rows] = v[imp, lane]
        ai, ni = a[~is_leaf], node[~is_leaf]
        counts[ai, 0] += 1
        left, right = meta[ni, 0].long(), meta[ni, 1].long()
        hl, el = test(ai, left)
        hr, er = test(ai, right)
        if bool((sp[ai] + hl.long() + hr.long() > STACK_CAP).any()):
            raise RuntimeError(f"BVH stack overflow (depth > {STACK_CAP - 2})")
        left_near = el <= er
        both = hl & hr
        far = torch.where(left_near, right, left)
        near = torch.where(left_near, left, right)
        push(ai[both], far[both], torch.where(left_near, er, el)[both])
        push(ai[both], near[both], torch.where(left_near, el, er)[both])
        one = hl ^ hr
        push(ai[one], torch.where(hl, left, right)[one],
             torch.where(hl, el, er)[one])
        walking = walking[sp[walking] > 0]
    hit = tri >= 0
    out = torch.zeros((R, 8), dtype=torch.float32, device=dev)
    out[:, 0] = torch.where(hit, best, t_max)
    out[:, 1] = tri.to(torch.float32)
    out[:, 2] = torch.where(hit, best_u, 0.0)
    out[:, 3] = torch.where(hit, best_v, 0.0)
    out[:, 6:8] = counts.to(torch.float32)
    return out


def trace_closest_bvh_full_plain(slabs, bounds, meta, ray_o, ray_d, t_min,
                                 t_max, skip_mask=None):
    """Plain closest hit with attributes -> (R, 16) full rows; clusters
    whose skip_mask entry is False are never tested."""
    live = None if skip_mask is None else skip_mask.to(torch.bool)
    return _full_rows(slabs, _closest_rows(
        slabs, *_leaf_boxes(bounds, meta, slabs.shape[0]), ray_o, ray_d,
        t_min, t_max, live))


def trace_any_bvh_plain(slabs, bounds, meta, ray_o, ray_d, t_min, t_max):
    """Plain any hit -> (R,) bool occlusion."""
    best_t, _, _, _ = _brute(
        slabs, *_leaf_boxes(bounds, meta, slabs.shape[0]), ray_o, ray_d,
        t_min, t_max, any_hit=True
    )
    return torch.isfinite(best_t)


def trace_any_bvh_dense_plain(slabs, bounds, meta, ray_o, ray_d, t_min,
                              t_max, skip_mask=None):
    """Plain dense any hit -> (R,) bool occlusion: K3's, over the live
    clusters of dense_aux. The kernel's packet cull lists every cluster
    whose leaf box some ray of the packet enters, a superset of what
    each ray tests, so the plain version leaves it out."""
    _, cmin, cmax, dead = dense_aux(slabs.shape[0], bounds, meta, skip_mask)
    best_t, _, _, _ = _brute(slabs, cmin, cmax, ray_o, ray_d, t_min, t_max,
                             any_hit=True, live=~dead)
    return torch.isfinite(best_t)


def dense_cull_counts_plain(slabs, bounds, meta, ray_o, ray_d, t_min,
                            t_max, skip_mask=None):
    """Plain version of K10's cull -> (P,) i32, P = ceil(R / 128): per
    packet of 128 consecutive rays, the live clusters of dense_aux whose
    leaf box some ray of the packet with t_max > t_min enters before its
    t_max (K3's slab test)."""
    C = slabs.shape[0]
    _, cmin, cmax, dead = dense_aux(C, bounds, meta, skip_mask)
    R = ray_o.shape[0]
    P = -(-R // DENSE_TILE)
    inv = safe_inv_dir(ray_d)
    live_ray = t_max > t_min
    listed = torch.zeros((P, C), dtype=torch.bool, device=ray_o.device)
    step = DENSE_TILE * 32
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)
        enter, exit_ = slab_enter_exit(ray_o[r0:r1, None], inv[r0:r1, None],
                                       cmin[None], cmax[None])
        ok = ((enter <= exit_) & (enter < t_max[r0:r1, None])
              & live_ray[r0:r1, None])
        pad = -(r1 - r0) % DENSE_TILE
        ok = torch.nn.functional.pad(ok, (0, 0, 0, pad))
        p0 = r0 // DENSE_TILE
        listed[p0:p0 + ok.shape[0] // DENSE_TILE] = (
            ok.reshape(-1, DENSE_TILE, C).any(dim=1))
    return (listed & ~dead).sum(dim=1).to(torch.int32)


def trace_closest_bvh_dense_plain(slabs, bounds, meta, ray_o, ray_d, t_min,
                                  t_max, skip_mask=None):
    """Plain dense closest hit -> (R, 8) rows, K2's over the live
    clusters of dense_aux (the packet cull lists a superset of what each
    ray tests, as in trace_any_bvh_dense_plain)."""
    _, cmin, cmax, dead = dense_aux(slabs.shape[0], bounds, meta, skip_mask)
    return _closest_rows(slabs, cmin, cmax, ray_o, ray_d, t_min, t_max,
                         live=~dead)


def dense_walk_counts(slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                      skip_mask=None):
    """What K9's walk tests -> (owned (R,) i32, the clusters each ray
    owns; entered (ceil(R / 32),) i32, per warp of 32 consecutive rays
    the clusters some lane owns, each of which the walk enters). A ray
    with t_max > t_min owns live cluster c when it enters c's leaf box
    before its best t over the clusters before c in id order (the walk's
    ballot, node_test against h.t); the whole warp then tests c once for
    each owner. The best t is the running minimum of every entered
    cluster's nearest hit, which equals the walk's unless a hit's
    rounded t lies below its own box's rounded entry. Plain PyTorch, for
    measurement only; inputs as trace_closest_bvh_dense."""
    dense_walk_counts.calls += 1
    dev = ray_o.device
    R, C = ray_o.shape[0], slabs.shape[0]
    t_max = as_tmax(t_max, R, dev)
    _, cmin, cmax, dead = dense_aux(C, bounds, meta, skip_mask)
    inv = safe_inv_dir(ray_d)
    owned = torch.zeros((R,), dtype=torch.int32, device=dev)
    entered = torch.zeros((-(-R // 32),), dtype=torch.int32, device=dev)
    ray_chunk, pair_chunk = _chunks(dev)  # ray_chunk: whole warps
    for r0 in range(0, R, ray_chunk):
        r1 = min(R, r0 + ray_chunk)
        tm = t_max[r0:r1]
        enter, exit_ = slab_enter_exit(ray_o[r0:r1, None], inv[r0:r1, None],
                                       cmin[None], cmax[None])
        ok = ((enter <= exit_) & (enter < tm[:, None])
              & (tm > t_min)[:, None] & ~dead[None])
        near = torch.full(ok.shape, float("inf"), device=dev)
        ri, ci = torch.nonzero(ok, as_tuple=True)
        for p0 in range(0, ri.shape[0], pair_chunk):
            rl, c = ri[p0:p0 + pair_chunk], ci[p0:p0 + pair_chunk]
            r = rl + r0
            s = slabs[c, 0:ROWS_PLAIN, :]
            hit, t, _, _ = moller_trumbore(
                ray_o[r][:, None, :], ray_d[r][:, None, :],
                s[:, 0:3].transpose(1, 2), s[:, 3:6].transpose(1, 2),
                s[:, 6:9].transpose(1, 2), t_min, t_max[r][:, None])
            near[rl, c] = torch.where(hit, t, float("inf")).min(dim=1).values
        best = torch.minimum(near, tm[:, None]).cummin(dim=1).values
        before = torch.cat([tm[:, None], best[:, :-1]], dim=1)
        own = ok & (enter < before)
        owned[r0:r1] = own.sum(1, dtype=torch.int32)
        own = torch.nn.functional.pad(own, (0, 0, 0, -(r1 - r0) % 32))
        entered[r0 // 32:r0 // 32 + own.shape[0] // 32] = (
            own.reshape(-1, 32, C).any(dim=1).sum(1, dtype=torch.int32))
    return owned, entered


dense_walk_counts.calls = 0


def nodes8_leaf_boxes(nodes8: torch.Tensor, n_clusters: int):
    """Cluster AABBs (C, 3) x 2 from the leaf slots of an 8-wide table
    (enc < 0 holds cluster -(enc + 1)); NaN, never entered, for a
    cluster no slot holds."""
    slots = nodes8.reshape(-1, 8)
    enc = slots[:, 6]
    leaf = enc < 0
    c = (-enc[leaf]).round().long() - 1
    cmin = torch.full((n_clusters, 3), float("nan"), dtype=torch.float32,
                      device=nodes8.device)
    cmax = cmin.clone()
    cmin[c] = slots[leaf, 0:3]
    cmax[c] = slots[leaf, 3:6]
    return cmin, cmax


def trace_closest_bvh8_plain(slabs, nodes8, ray_o, ray_d, t_min, t_max):
    """Plain 8-wide closest hit -> (R, 8) rows, K2's plain version over
    the table's leaf boxes."""
    return _closest_rows(slabs, *nodes8_leaf_boxes(nodes8, slabs.shape[0]),
                         ray_o, ray_d, t_min, t_max)


def trace_closest_bvh8_full_plain(slabs, nodes8, ray_o, ray_d, t_min,
                                  t_max):
    """Plain 8-wide closest hit with attributes -> (R, 16) full rows."""
    return _full_rows(slabs, trace_closest_bvh8_plain(
        slabs, nodes8, ray_o, ray_d, t_min, t_max))


def trace_any_bvh8_plain(slabs, nodes8, ray_o, ray_d, t_min, t_max):
    """Plain 8-wide any hit -> (R,) bool occlusion."""
    best_t, _, _, _ = _brute(
        slabs, *nodes8_leaf_boxes(nodes8, slabs.shape[0]), ray_o, ray_d,
        t_min, t_max, any_hit=True)
    return torch.isfinite(best_t)


def trace_primary_bvh_full_plain(slabs, bounds, meta, pix_cols, cam_vec,
                                 frame_index, t_min):
    """Plain primary trace -> (T*256, 16) full hit rows."""
    o, d, tmax = raygen_plain(pix_cols, cam_vec, frame_index)
    return _full_rows(slabs, _closest_rows(
        slabs, *_leaf_boxes(bounds, meta, slabs.shape[0]), o.contiguous(), d,
        t_min, tmax))


# ---------------------------------------------------------------------------
# Kernel wrappers

_P = ctypes.c_void_p
# the C entry points' arguments before the stream (cuda_build.launch)
_ARGTYPES = {
    "trace_closest_bvh": [_P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
                          ctypes.c_float, _P, _P],
    "trace_any_bvh": [_P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
                      ctypes.c_float, _P, _P],
    "trace_primary_bvh_full": [_P, ctypes.c_int, _P, _P, _P, ctypes.c_int,
                               _P, ctypes.c_int, ctypes.c_float, _P, _P],
    "trace_closest_bvh_full": [_P, ctypes.c_int, _P, _P, _P, _P, _P,
                               ctypes.c_int, ctypes.c_float, _P, _P, _P],
    "trace_any_bvh_dense": [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                            _P, _P, _P, ctypes.c_int, ctypes.c_float, _P],
}
_ARGTYPES["trace_closest_bvh_visits"] = _ARGTYPES["trace_closest_bvh"]
_ARGTYPES["trace_closest_bvh_dense"] = _ARGTYPES["trace_any_bvh_dense"]
_ARGTYPES["dense_cull_counts"] = [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
                                  ctypes.c_int, ctypes.c_float, _P]
_ARGTYPES["trace_closest_bvh8"] = [_P, ctypes.c_int, _P, _P, _P, _P,
                                   ctypes.c_int, ctypes.c_float, _P, _P]
_ARGTYPES["trace_closest_bvh8_full"] = _ARGTYPES["trace_closest_bvh8"]
_ARGTYPES["trace_any_bvh8"] = _ARGTYPES["trace_closest_bvh8"]
DENSE_TILE = 128  # rays per packet of K9, K10 (trace_bvh.py:1154, :1819)
MAX_SHARED = 232448  # bytes of shared memory one H100 block can have
# the packet's staged rays, the warps' counts, one node stack per warp
# and a flag word (csrc/trace_bvh.cu DenseShared)
DENSE_STATIC_SMEM = 4 * (7 * DENSE_TILE + (DENSE_TILE // 32) * (1 + STACK_CAP)
                         + 1)


def dense_list_bytes(n_clusters: int) -> int:
    """Shared memory of one K9 or K10 block: the cluster list (one int
    per cluster), the bitmap of entered clusters, the packet's staged
    rays and the cull's node stacks."""
    n = int(n_clusters)
    return 4 * (n + -(-n // 32)) + DENSE_STATIC_SMEM


def expect_tensor(t: torch.Tensor, name: str, dtype, device, shape=None):
    """Raise unless t has this dtype, device, contiguity and shape (None
    in `shape`: any size): the check every kernel wrapper makes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and (
        t.dim() != len(shape)
        or any(s is not None and s != n for s, n in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _check_scene(slabs, bounds, meta, device, min_rows=ROWS_PLAIN):
    expect_tensor(slabs, "slabs", torch.float32, device,
                  (None, None, CLUSTER_PAD))
    if slabs.shape[1] < min_rows:
        raise ValueError(f"slabs need >= {min_rows} rows, got {slabs.shape[1]}")
    expect_tensor(bounds, "bounds", torch.float32, device, (None, 6))
    expect_tensor(meta, "meta", torch.int32, device, (bounds.shape[0], 3))


def as_tmax(t_max, R: int, device) -> torch.Tensor:
    """t_max as (R,) f32 on device; a Python scalar is filled in place,
    with no host-to-device copy."""
    if not isinstance(t_max, torch.Tensor):
        return torch.full((R,), float(t_max), dtype=torch.float32,
                          device=device)
    return t_max.to(device, torch.float32).expand(R).contiguous()


_OVERFLOW: dict[int, torch.Tensor] = {}  # CUDA device index -> int32 flag


def _overflow_flag(device: torch.device) -> torch.Tensor:
    """The device int every kernel on `device` sets to 1 when a ray
    overflows its node stack; read and cleared by check_stack_overflow."""
    index = torch.cuda.current_device() if device.index is None else device.index
    flag = _OVERFLOW.get(index)
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        _OVERFLOW[index] = flag
    return flag


def check_stack_overflow(device, site: str = "check_stack_overflow") -> None:
    """Raise if a trace kernel launched on `device` since the last check
    overflowed its node stack (BVH2 depth > STACK_CAP - 2, or an 8-wide
    walk needing more than STACK8_CAP entries), and clear the flag. Waits
    for those kernels, in a wait span named `site` (the caller's);
    does nothing for the CPU, whose plain versions keep no stack.
    pt_trace_pixels calls it once per frame; callers of the wrappers call
    it after their launches."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    flag = _overflow_flag(device)
    with gprofiler.wait(site):
        overflowed = int(flag.item()) != 0
    if overflowed:
        flag.zero_()
        raise RuntimeError(
            f"BVH stack overflow in a trace kernel (BVH2 depth > "
            f"{STACK_CAP - 2} or 8-wide stack > {STACK8_CAP})"
        )


def _launch(name: str, device, args) -> None:
    """Launch a stack-walking kernel of csrc/trace_bvh.cu with the
    device's overflow flag."""
    from . import cuda_build

    cuda_build.launch("trace_bvh", name, _ARGTYPES[name], device,
                      (*args, _overflow_flag(device).data_ptr()))


def trace_closest_bvh(slabs, bounds, meta, ray_o, ray_d, t_min, t_max):
    """Closest hit of R rays -> (R, 8) rows t | tri | u | v | pad.

    slabs (C, >=9, 128) f32; bounds (N, 6) f32; meta (N, 3) i32; ray_o,
    ray_d (R, 3) f32; t_max scalar or (R,). A miss row has t = t_max,
    tri = -1."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh_plain(slabs, bounds, meta, ray_o, ray_d,
                                       float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh: unsupported device {dev}")
    _check_scene(slabs, bounds, meta, dev)
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    _launch("trace_closest_bvh", dev, (
        slabs.data_ptr(), slabs.shape[1], bounds.data_ptr(), meta.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), R,
        float(t_min), out.data_ptr(),
    ))
    trace_closest_bvh.launches += 1
    return out


def trace_closest_bvh_visits(slabs, bounds, meta, ray_o, ray_d, t_min,
                             t_max):
    """X3a: K2's closest hit with its walk's counts -> (R, 8) rows t |
    tri | u | v | 0 | 0 | interior nodes expanded | leaves tested, rows
    0-5 equal to trace_closest_bvh's; inputs as trace_closest_bvh."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh_visits_plain(slabs, bounds, meta, ray_o,
                                              ray_d, float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh_visits: unsupported device {dev}")
    _check_scene(slabs, bounds, meta, dev)
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    _launch("trace_closest_bvh_visits", dev, (
        slabs.data_ptr(), slabs.shape[1], bounds.data_ptr(), meta.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), R,
        float(t_min), out.data_ptr(),
    ))
    trace_closest_bvh_visits.launches += 1
    return out


def trace_any_bvh(slabs, bounds, meta, ray_o, ray_d, t_min, t_max):
    """Any hit (shadow rays) of R rays -> (R,) bool occlusion, a hit
    being t_min < t < t_max."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_any_bvh_plain(slabs, bounds, meta, ray_o, ray_d,
                                   float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_any_bvh: unsupported device {dev}")
    _check_scene(slabs, bounds, meta, dev)
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    _launch("trace_any_bvh", dev, (
        slabs.data_ptr(), slabs.shape[1], bounds.data_ptr(), meta.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), R,
        float(t_min), occ.data_ptr(),
    ))
    trace_any_bvh.launches += 1
    return occ


def trace_closest_bvh_full(slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                           skip_mask=None):
    """Closest hit of R rays with attributes -> (R, 16) full rows t | tri
    | normal3 | tangent4 | uv2 | material | tri_lod | pad3; a miss row
    has t = t_max, tri = -1 and zero attributes.

    slabs (C, 40, 128) f32; ray_o, ray_d (R, 3) f32; t_max scalar or
    (R,); skip_mask (C,) bool or None: a cluster marked False is never
    tested (its leaf is skipped in the walk)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh_full_plain(slabs, bounds, meta, ray_o,
                                            ray_d, float(t_min), t_max,
                                            skip_mask)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh_full: unsupported device {dev}")
    _check_scene(slabs, bounds, meta, dev, min_rows=ROWS_FULL - 2)
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    live = 0
    if skip_mask is not None:
        expect_tensor(skip_mask, "skip_mask", torch.bool, dev,
                      (slabs.shape[0],))
        live = skip_mask.data_ptr()
    out = torch.empty((R, 16), dtype=torch.float32, device=dev)
    _launch("trace_closest_bvh_full", dev, (
        slabs.data_ptr(), slabs.shape[1], bounds.data_ptr(), meta.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), R,
        float(t_min), live, out.data_ptr(),
    ))
    trace_closest_bvh_full.launches += 1
    return out


def trace_primary_bvh_full(slabs, bounds, meta, pix_cols, cam_vec,
                           frame_index: int, t_min: float):
    """Closest hit of in-kernel generated pinhole primary rays -> (T*256,
    16) full rows (pad lanes come back as misses with t = 0).

    slabs (C, 40, 128); pix_cols (T, 3, 256) from pack_pixels_np;
    cam_vec (1, 24) from primary_cam_vec. With pcg_on = 1 the jitter
    equals mathx.rng.rnd2d01(make_state(px, py, frame_index)) bit for
    bit; the rays equal raygen_plain's."""
    dev = pix_cols.device
    T = pix_cols.shape[0]
    if dev.type == "cpu":
        return trace_primary_bvh_full_plain(
            slabs, bounds, meta, pix_cols, cam_vec, int(frame_index),
            float(t_min),
        )
    if dev.type != "cuda":
        raise ValueError(f"trace_primary_bvh_full: unsupported device {dev}")
    _check_scene(slabs, bounds, meta, dev, min_rows=ROWS_FULL - 2)
    expect_tensor(pix_cols, "pix_cols", torch.float32, dev, (T, 3, TILE))
    expect_tensor(cam_vec, "cam_vec", torch.float32, dev, (1, 24))
    R = T * TILE
    out = torch.empty((R, 16), dtype=torch.float32, device=dev)
    _launch("trace_primary_bvh_full", dev, (
        slabs.data_ptr(), slabs.shape[1], bounds.data_ptr(), meta.data_ptr(),
        pix_cols.data_ptr(), R, cam_vec.data_ptr(), int(frame_index),
        float(t_min), out.data_ptr(),
    ))
    trace_primary_bvh_full.launches += 1
    return out


def _dense_inputs(name, slabs, bounds, meta, ray_o, ray_d, skip_mask):
    """Check the inputs of K9, K10 or K10's cull -> (C, node_of, the skip
    mask's pointer or 0)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    _check_scene(slabs, bounds, meta, dev)
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    C = slabs.shape[0]
    if dense_list_bytes(C) > MAX_SHARED:
        raise ValueError(
            f"{name}: the cluster list of {C} clusters needs "
            f"{dense_list_bytes(C)} bytes of shared memory, more than a "
            f"block has ({MAX_SHARED})")
    live = 0
    if skip_mask is not None:
        expect_tensor(skip_mask, "skip_mask", torch.bool, dev, (C,))
        live = skip_mask.data_ptr()
    return C, dense_aux(C, bounds, meta)[0], live


def _launch_dense(name, slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                  skip_mask, out):
    """Check the inputs of K9 or K10 and launch it into out."""
    C, node_of, live = _dense_inputs(name, slabs, bounds, meta, ray_o, ray_d,
                                     skip_mask)
    from . import cuda_build

    cuda_build.launch("trace_bvh", name, _ARGTYPES[name], ray_o.device, (
        slabs.data_ptr(), slabs.shape[1], C, bounds.data_ptr(),
        meta.data_ptr(), node_of.data_ptr(), live, ray_o.data_ptr(),
        ray_d.data_ptr(),
        t_max.data_ptr(), ray_o.shape[0], float(t_min), out.data_ptr()))
    return out


def trace_any_bvh_dense(slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                        skip_mask=None):
    """Any hit of R rays through the dense cull -> (R,) bool occlusion,
    a hit being t_min < t < t_max: the same mask as trace_any_bvh.

    slabs (C, >=9, 128) f32; bounds (N, 6) f32; meta (N, 3) i32; ray_o,
    ray_d (R, 3) f32; t_max scalar or (R,); skip_mask (C,) bool or None:
    a cluster marked False is never tested."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_any_bvh_dense_plain(slabs, bounds, meta, ray_o, ray_d,
                                         float(t_min), t_max, skip_mask)
    if dev.type != "cuda":
        raise ValueError(f"trace_any_bvh_dense: unsupported device {dev}")
    occ = _launch_dense("trace_any_bvh_dense", slabs, bounds, meta, ray_o,
                        ray_d, t_min, t_max, skip_mask,
                        torch.empty((R,), dtype=torch.bool, device=dev))
    trace_any_bvh_dense.launches += 1
    return occ


def trace_closest_bvh_dense(slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                            skip_mask=None):
    """Closest hit of R rays through the dense cull -> (R, 8) rows t | tri
    | u | v | pad, as trace_closest_bvh: a miss row has t = t_max, tri =
    -1; among exact t ties the lowest tri.

    slabs (C, >=9, 128) f32; bounds (N, 6) f32; meta (N, 3) i32; ray_o,
    ray_d (R, 3) f32; t_max scalar or (R,); skip_mask (C,) bool or None:
    a cluster marked False is never tested."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh_dense_plain(slabs, bounds, meta, ray_o,
                                             ray_d, float(t_min), t_max,
                                             skip_mask)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh_dense: unsupported device {dev}")
    out = _launch_dense("trace_closest_bvh_dense", slabs, bounds, meta, ray_o,
                        ray_d, t_min, t_max, skip_mask,
                        torch.empty((R, 8), dtype=torch.float32, device=dev))
    trace_closest_bvh_dense.launches += 1
    return out


def dense_cull_counts(slabs, bounds, meta, ray_o, ray_d, t_min, t_max,
                      skip_mask=None):
    """K10's dense cull alone -> (ceil(R / 128),) i32, the number of
    clusters each 128-ray packet lists for K10's walk; inputs as
    trace_any_bvh_dense (the slabs are checked, not read)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return dense_cull_counts_plain(slabs, bounds, meta, ray_o, ray_d,
                                       float(t_min), t_max, skip_mask)
    if dev.type != "cuda":
        raise ValueError(f"dense_cull_counts: unsupported device {dev}")
    C, node_of, live = _dense_inputs("dense_cull_counts", slabs, bounds,
                                     meta, ray_o, ray_d, skip_mask)
    counts = torch.empty((-(-R // DENSE_TILE),), dtype=torch.int32,
                         device=dev)
    from . import cuda_build

    cuda_build.launch("trace_bvh", "dense_cull_counts",
                      _ARGTYPES["dense_cull_counts"], dev, (
                          C, bounds.data_ptr(), meta.data_ptr(),
                          node_of.data_ptr(), live,
                          ray_o.data_ptr(), ray_d.data_ptr(),
                          t_max.data_ptr(), R, float(t_min),
                          counts.data_ptr()))
    dense_cull_counts.launches += 1
    return counts


def _launch8(name, slabs, nodes8, ray_o, ray_d, t_min, t_max, out,
             min_rows=ROWS_PLAIN):
    """Check the inputs of K11, K12 or K13 and launch it into out."""
    dev = ray_o.device
    R = ray_o.shape[0]
    expect_tensor(slabs, "slabs", torch.float32, dev,
                  (None, None, CLUSTER_PAD))
    if slabs.shape[1] < min_rows:
        raise ValueError(f"slabs need >= {min_rows} rows, got {slabs.shape[1]}")
    expect_tensor(nodes8, "nodes8", torch.float32, dev, (None, 8, 8))
    if nodes8.data_ptr() % 16:
        raise ValueError("nodes8 must be 16-byte aligned (float4 loads)")
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    _launch(name, dev, (
        slabs.data_ptr(), slabs.shape[1], nodes8.data_ptr(),
        ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(), R,
        float(t_min), out.data_ptr(),
    ))
    return out


def trace_closest_bvh8(slabs, nodes8, ray_o, ray_d, t_min, t_max):
    """Closest hit of R rays by the 8-wide walk -> (R, 8) rows t | tri |
    u | v | pad, as trace_closest_bvh: a miss row has t = t_max, tri =
    -1; among exact t ties the lowest tri.

    slabs (C, >=9, 128) f32; nodes8 (N8, 8, 8) f32 from
    accel/bvh.pack_nodes8; ray_o, ray_d (R, 3) f32; t_max scalar or (R,)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh8_plain(slabs, nodes8, ray_o, ray_d,
                                        float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh8: unsupported device {dev}")
    out = _launch8("trace_closest_bvh8", slabs, nodes8, ray_o, ray_d, t_min,
                   t_max, torch.empty((R, 8), dtype=torch.float32, device=dev))
    trace_closest_bvh8.launches += 1
    return out


def trace_closest_bvh8_full(slabs, nodes8, ray_o, ray_d, t_min, t_max):
    """Closest hit of R rays by the 8-wide walk with attributes -> (R, 16)
    full rows, as trace_closest_bvh_full without a skip mask.

    slabs (C, 40, 128) f32; the rest as trace_closest_bvh8."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_closest_bvh8_full_plain(slabs, nodes8, ray_o, ray_d,
                                             float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_bvh8_full: unsupported device {dev}")
    out = _launch8("trace_closest_bvh8_full", slabs, nodes8, ray_o, ray_d,
                   t_min, t_max,
                   torch.empty((R, 16), dtype=torch.float32, device=dev),
                   min_rows=ROWS_FULL - 2)
    trace_closest_bvh8_full.launches += 1
    return out


def trace_any_bvh8(slabs, nodes8, ray_o, ray_d, t_min, t_max):
    """Any hit of R rays by the 8-wide walk -> (R,) bool occlusion, a hit
    being t_min < t < t_max; inputs as trace_closest_bvh8."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return trace_any_bvh8_plain(slabs, nodes8, ray_o, ray_d,
                                    float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_any_bvh8: unsupported device {dev}")
    occ = _launch8("trace_any_bvh8", slabs, nodes8, ray_o, ray_d, t_min,
                   t_max, torch.empty((R,), dtype=torch.bool, device=dev))
    trace_any_bvh8.launches += 1
    return occ


trace_closest_bvh.launches = 0
trace_any_bvh.launches = 0
trace_primary_bvh_full.launches = 0
trace_closest_bvh_full.launches = 0
trace_any_bvh_dense.launches = 0
trace_closest_bvh_dense.launches = 0
trace_closest_bvh8.launches = 0
trace_closest_bvh8_full.launches = 0
trace_any_bvh8.launches = 0
trace_closest_bvh_visits.launches = 0
dense_cull_counts.launches = 0
KERNELS = (trace_primary_bvh_full, trace_closest_bvh, trace_any_bvh,
           trace_closest_bvh_full, trace_any_bvh_dense,
           trace_closest_bvh_dense, trace_closest_bvh8,
           trace_closest_bvh8_full, trace_any_bvh8, trace_closest_bvh_visits,
           dense_cull_counts)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
