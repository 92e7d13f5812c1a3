"""Flat cull-list trace kernels: wrappers and plain PyTorch versions.

Counterpart of prosper_tpu/ops/trace_pallas.py (`_cull_lists` :49,
`_prep` :240, `trace_closest_pallas` :272, `trace_any_pallas` :396) and
prosper_tpu/ops/trace_pallas_full.py (`trace_closest_full` :255): the
tracers of frames without BVH node arrays, over the cluster AABBs
`wc_min`, `wc_max` (C, 3). Three kernels, hand-written CUDA in
csrc/trace_flat.cu, each with a plain PyTorch twin:

- `trace_closest_flat` (K6, replaces trace_closest_pallas): closest hit
  -> (R, 8) rows t | tri | u | v | pad, as K2 (ops/trace_bvh.py);
- `trace_closest_flat_full` (K8, replaces trace_closest_full): the same
  hit and the winning triangle's attributes -> (R, 16) rows, as K4;
- `trace_any_flat` (K7, replaces trace_any_pallas): any hit -> (R,) bool
  occlusion, as K3.

Contract: the closest hit of each ray (t_min < t < t_max, per ray) over
every cluster whose AABB the ray enters; a masked cluster carries an
inverted AABB (render/gbuffer._masked_aabbs) that no ray enters. A miss
row has t = t_max, tri = -1 and zero attributes. Exact t ties go to the
lowest triangle id. The any hit: a ray is occluded when a triangle of a
cluster whose AABB it enters has t_min < t < t_max, so a ray with t_max
<= t_min never is. t_min is honoured (the Pallas kernels hard-code 1e-4
closest and 0.1 any hit).

How the clusters are found, in the kernels and in the plain versions
alike: every 256 consecutive rays form a tile (the last one may be
short); `packet_overlap` culls all clusters against each tile's packet
bounds with ops/intersect.packet_aabb_enter_exit (a tile with no t_max
above t_min lists nothing), and each ray then tests its own slab entry
into every listed cluster. The packet cull is conservative, so the tile
decides speed, not the result; callers give rays in 16x16 pixel blocks.
The per-tile lists of the Pallas kernels, their SMEM copies and slab DMA
ring are TPU devices; `cull_lists` gives the order the CUDA kernels walk
a tile's list in (front to back, as trace_pallas._cull_lists; K7 walks
it in id order, since any order gives the same mask). All three walk it
warp by warp under chunk boxes (the exact union of 32 consecutive
entries' AABBs, which a ray must enter to enter any of them) and test
each cluster a lane enters with the whole warp: K6 and K8 those it
enters before its best hit, K7 those it enters before its t_max until
it is occluded. Since exact t ties go to the lowest triangle id over
all clusters, the rows equal the plain versions' bit for bit whatever
order a cluster is reached in, and so does K7's mask.

`flat_walk_counts` is a measurement of the walk in plain PyTorch (no
kernel): per ray, its tile's list length, the listed clusters it enters
and those it enters no later than its final hit, the least any walk of
that list must test (K7's walk: t_hit = t_max). Only chip_smoke.py calls it; it
counts its calls in `.calls`, and a frame that called it fails that run.

Dispatch: a wrapper runs the plain version only because its tensors lie
on the CPU; on CUDA tensors it launches the kernel or raises. Each
wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from .intersect import (
    BIG,
    packet_aabb_enter_exit,
    safe_inv_dir,
    slab_enter_exit,
)
from .slabs import ROWS_FULL, ROWS_PLAIN
from .trace import CLUSTER_PAD, TILE
from .trace_bvh import (
    MAX_SHARED,
    _brute,
    _closest_rows,
    _full_rows,
    as_tmax,
    expect_tensor,
)

CHUNK = 32  # list entries under one chunk box of the walk
TILES_PER_CHUNK = 512  # tiles per packet-cull chunk of the plain version
RAYS_PER_CHUNK = 16384  # rays per slab-test chunk of flat_walk_counts


def _packets(ray_o, ray_d, t_max):
    """Per-tile packet bounds of 256 consecutive rays: (o_lo, o_hi, d_lo,
    d_hi (T, 3), largest t_max (T,)); a short last tile is padded with
    copies of its last ray."""
    R = ray_o.shape[0]
    pad = (-R) % TILE

    def tiles(a):
        if pad:
            a = torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
        return a.reshape((-1, TILE) + a.shape[1:])

    o_t, d_t = tiles(ray_o), tiles(ray_d)
    return (o_t.amin(1), o_t.amax(1), d_t.amin(1), d_t.amax(1),
            tiles(t_max).amax(1))


def packet_overlap(ray_o, ray_d, t_min, t_max, wc_min, wc_max):
    """The kernels' per-tile cull: (overlap (T, C) bool, key (T, C) f32)
    with overlap = enter <= exit, exit >= 0 and enter <= the tile's
    largest t_max (none where that is not above t_min), key = max(enter,
    0), the packet's entry distance."""
    o_lo, o_hi, d_lo, d_hi, tile_tmax = _packets(ray_o, ray_d, t_max)
    overlap, key = [], []
    for t0 in range(0, o_lo.shape[0], TILES_PER_CHUNK):
        sl = slice(t0, t0 + TILES_PER_CHUNK)
        enter, exit_ = packet_aabb_enter_exit(
            o_lo[sl, None], o_hi[sl, None], d_lo[sl, None], d_hi[sl, None],
            wc_min[None], wc_max[None])
        tm = tile_tmax[sl, None]
        overlap.append((enter <= exit_) & (exit_ >= 0.0) & (enter <= tm)
                       & (tm > t_min))
        key.append(torch.clamp_min(enter, 0.0))
    return torch.cat(overlap), torch.cat(key)


def cull_lists(ray_o, ray_d, t_min, t_max, wc_min, wc_max):
    """Per-tile cluster lists in the order the kernels walk them ->
    (lists (T, C) i32, counts (T,) i32, keys (T, C) f32): each tile's
    overlapping clusters first, front to back by key, ties by id, then
    the others with key 3e38 (trace_pallas._cull_lists with every
    cluster kept)."""
    t_max = as_tmax(t_max, ray_o.shape[0], ray_o.device)
    overlap, key = packet_overlap(ray_o, ray_d, t_min, t_max, wc_min, wc_max)
    keys, order = torch.sort(torch.where(overlap, key, BIG), dim=1,
                             stable=True)
    return order.to(torch.int32), overlap.sum(1).to(torch.int32), keys


def trace_closest_flat_plain(slabs, wc_min, wc_max, ray_o, ray_d, t_min,
                             t_max):
    """Plain flat closest hit -> (R, 8) rows t | tri | u | v | 0 0 0 0."""
    t_max = as_tmax(t_max, ray_o.shape[0], ray_o.device)
    overlap, _ = packet_overlap(ray_o, ray_d, t_min, t_max, wc_min, wc_max)
    return _closest_rows(slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max,
                         tile_ok=overlap)


def trace_closest_flat_full_plain(slabs, wc_min, wc_max, ray_o, ray_d,
                                  t_min, t_max):
    """Plain flat closest hit with attributes -> (R, 16) full rows."""
    return _full_rows(slabs, trace_closest_flat_plain(
        slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max))


def trace_any_flat_plain(slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Plain flat any hit -> (R,) bool occlusion. The packet cull only
    adds clusters that a ray's own box test then rejects, so the mask
    does not depend on which rays share a tile."""
    t_max = as_tmax(t_max, ray_o.shape[0], ray_o.device)
    overlap, _ = packet_overlap(ray_o, ray_d, t_min, t_max, wc_min, wc_max)
    best_t, _, _, _ = _brute(slabs, wc_min, wc_max, ray_o, ray_d, t_min,
                             t_max, any_hit=True, tile_ok=overlap)
    return torch.isfinite(best_t)


def flat_walk_counts(wc_min, wc_max, ray_o, ray_d, t_min, t_max, t_hit):
    """What the flat walk faces, per ray -> (R, 3) i32: its tile's
    list length (packet_overlap); the listed clusters whose AABB it
    enters before its t_max (enter <= exit, enter < t_max), the owner
    test of a walk that has found no hit yet; and of those, the ones it
    enters no later than t_hit (R,), its final t (t_max on a miss), the
    least any walk of the list must test (for K7, given t_hit = t_max,
    the clusters a free ray tests). A ray with t_max <= t_min enters
    nothing. Plain PyTorch, for measurement only."""
    flat_walk_counts.calls += 1
    R = ray_o.shape[0]
    t_max = as_tmax(t_max, R, ray_o.device)
    overlap, _ = packet_overlap(ray_o, ray_d, t_min, t_max, wc_min, wc_max)
    inv = safe_inv_dir(ray_d)
    out = torch.zeros((R, 3), dtype=torch.int32, device=ray_o.device)
    for r0 in range(0, R, RAYS_PER_CHUNK):
        r1 = min(R, r0 + RAYS_PER_CHUNK)
        listed = overlap[torch.arange(r0, r1, device=ray_o.device) // TILE]
        enter, exit_ = slab_enter_exit(ray_o[r0:r1, None], inv[r0:r1, None],
                                       wc_min[None], wc_max[None])
        live = (t_max[r0:r1] > t_min)[:, None]
        entered = (listed & live & (enter <= exit_)
                   & (enter < t_max[r0:r1, None]))
        needed = entered & (enter <= t_hit[r0:r1, None])
        out[r0:r1, 0] = listed.sum(1, dtype=torch.int32)
        out[r0:r1, 1] = entered.sum(1, dtype=torch.int32)
        out[r0:r1, 2] = needed.sum(1, dtype=torch.int32)
    return out


flat_walk_counts.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrappers

_P = ctypes.c_void_p
# the C entry points' arguments before the stream (cuda_build.launch)
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
             ctypes.c_float, _P]


def list_bytes(n_clusters: int) -> int:
    """Shared memory of one block (csrc/trace_flat.cu list_smem): a
    (key, id) list of the next power of two above n_clusters entries,
    then the chunk boxes (6 floats for every CHUNK entries)."""
    cap = 1 << max(0, int(n_clusters) - 1).bit_length()
    return 4 * (2 * cap + 6 * -(-cap // CHUNK))


def _launch(name, slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max,
            min_rows, out_shape, out_dtype=torch.float32):
    dev = ray_o.device
    R = ray_o.shape[0]
    C = slabs.shape[0]
    expect_tensor(slabs, "slabs", torch.float32, dev,
                  (None, None, CLUSTER_PAD))
    if slabs.shape[1] < min_rows:
        raise ValueError(f"slabs need >= {min_rows} rows, got {slabs.shape[1]}")
    expect_tensor(wc_min, "wc_min", torch.float32, dev, (C, 3))
    expect_tensor(wc_max, "wc_max", torch.float32, dev, (C, 3))
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    if list_bytes(C) > MAX_SHARED:
        raise ValueError(
            f"{name}: the cull list of {C} clusters needs "
            f"{list_bytes(C)} bytes of shared memory, more than a "
            f"block has ({MAX_SHARED})")
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    from . import cuda_build

    cuda_build.launch("trace_flat", name, _ARGTYPES, dev, (
        slabs.data_ptr(), slabs.shape[1], C, wc_min.data_ptr(),
        wc_max.data_ptr(), ray_o.data_ptr(), ray_d.data_ptr(),
        t_max.data_ptr(), R, float(t_min), out.data_ptr()))
    return out


def trace_closest_flat(slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Flat closest hit of R rays -> (R, 8) rows t | tri | u | v | pad.

    slabs (C, >=9, 128) f32; wc_min, wc_max (C, 3) f32 (inverted where a
    cluster is masked); ray_o, ray_d (R, 3) f32; t_max scalar or (R,)."""
    dev = ray_o.device
    t_max = as_tmax(t_max, ray_o.shape[0], dev)
    if dev.type == "cpu":
        return trace_closest_flat_plain(slabs, wc_min, wc_max, ray_o, ray_d,
                                        float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_flat: unsupported device {dev}")
    out = _launch("trace_closest_flat", slabs, wc_min, wc_max, ray_o, ray_d,
                  t_min, t_max, ROWS_PLAIN, (ray_o.shape[0], 8))
    trace_closest_flat.launches += 1
    return out


def trace_closest_flat_full(slabs, wc_min, wc_max, ray_o, ray_d, t_min,
                            t_max):
    """Flat closest hit of R rays with attributes -> (R, 16) full rows t |
    tri | normal3 | tangent4 | uv2 | material | tri_lod | pad3.

    slabs (C, 40, 128) f32; otherwise as trace_closest_flat."""
    dev = ray_o.device
    t_max = as_tmax(t_max, ray_o.shape[0], dev)
    if dev.type == "cpu":
        return trace_closest_flat_full_plain(slabs, wc_min, wc_max, ray_o,
                                             ray_d, float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_closest_flat_full: unsupported device {dev}")
    out = _launch("trace_closest_flat_full", slabs, wc_min, wc_max, ray_o,
                  ray_d, t_min, t_max, ROWS_FULL - 2, (ray_o.shape[0], 16))
    trace_closest_flat_full.launches += 1
    return out


def trace_any_flat(slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Flat any hit (shadow rays) of R rays -> (R,) bool occlusion, a hit
    being t_min < t < t_max.

    slabs (C, >=9, 128) f32; wc_min, wc_max (C, 3) f32 (inverted where a
    cluster is masked); ray_o, ray_d (R, 3) f32; t_max scalar or (R,)."""
    dev = ray_o.device
    t_max = as_tmax(t_max, ray_o.shape[0], dev)
    if dev.type == "cpu":
        return trace_any_flat_plain(slabs, wc_min, wc_max, ray_o, ray_d,
                                    float(t_min), t_max)
    if dev.type != "cuda":
        raise ValueError(f"trace_any_flat: unsupported device {dev}")
    out = _launch("trace_any_flat", slabs, wc_min, wc_max, ray_o, ray_d,
                  t_min, t_max, ROWS_PLAIN, (ray_o.shape[0],), torch.bool)
    trace_any_flat.launches += 1
    return out


trace_closest_flat.launches = 0
trace_closest_flat_full.launches = 0
trace_any_flat.launches = 0
KERNELS = (trace_closest_flat, trace_closest_flat_full, trace_any_flat)
