"""Leaf-major tracing of incoherent (bounce and shadow) rays.

Counterpart of prosper_tpu/ops/trace_leafmajor.py. Instead of walking
the BVH ray by ray, the tracer lists the exact (ray, candidate leaf)
pairs, groups them by leaf into blocks of at most 256 rays, and runs one
dense Möller block per (leaf, block): the leaf's 9x128 slab against the
block's rays. The minimum t over a ray's pairs is its closest hit.

- `candidate_lists` (:90): the two-level cull. Level 1 culls every
  cluster AABB against each 256-ray tile's packet bounds
  (intersect.packet_aabb_overlap_2d) and keeps each tile's first
  VIS_CAP candidates in id order; level 2 runs the exact per-ray slab
  test on (tile, candidate) and keeps each ray's first PAIR_CAP_PER_RAY
  entered clusters, ascending. A ray with more is "heavy", and so is
  every ray of a tile with more than VIS_CAP candidates.
- `pairs_from_lists` (:184) and `build_blocks` (:226): the pairs, one
  stable sort by leaf, and the 256-slot blocks, B = P // 256 + C.
- `run_pairs` (K14, replaces `_run_pairs` :397, kernel `_pairs_kernel`
  :275): Möller of each block's rays against its leaf. Hand-written
  CUDA in csrc/trace_leafmajor.cu with the plain twin `run_pairs_plain`:
  one persistent launch that tests the live quarter blocks, four threads
  a slot, then writes the empty blocks' misses in 16-byte stores (on
  incoherent sets almost every one of the B blocks is empty). The
  kernel reads each slot's ray by index (slot_ray), not from the
  gathered (B, 8, 256) columns of the Pallas kernel.
- `closest_from_pairs` / `any_from_pairs` (:487, :564): the per-ray
  combine, a scatter-min over the slots (smallest t, then lowest tri).
- `trace_closest_hybrid` / `trace_any_hybrid` (:598, :646): light rays
  through the pair blocks, heavy rays through K2 / K3 over all R rays
  with the light ones disabled by t_max = 0 (`_heavy_perm`, a TPU
  coherence device, is not carried). Exact, and the `_safe` forms
  (:676, :693, :705) are the make_bounce_tracer contract.
- `trace_closest_leafmajor` / `trace_any_leafmajor` (:462, :541): the
  non-hybrid tracers with their overflow flag, over the tiled
  enumeration (`enumerate_pairs_tiled`); `enumerate_pairs` (:50) is the
  dense O(R x C) one, whose pairs are already grouped by leaf.
- `attrs_from_hit` (:718): the attribute set at the final hit.

Every shape is fixed by R and C, so the frame issues no host wait. The
level-2 temporaries are (tiles, 256, VIS_CAP) and are built a chunk of
tiles at a time.

Dispatch: `run_pairs` runs its plain version only because its tensors
lie on the CPU; on CUDA tensors it launches the kernel or raises. It
counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import trace_bvh
from .intersect import moller_trumbore, packet_aabb_overlap_2d, safe_inv_dir
from .slabs import ROWS_PLAIN, unpack_hit8
from .trace import CLUSTER_PAD

PAIR_CAP_PER_RAY = 8  # candidate leaves kept per ray
ENUM_TILE = 256  # rays per level-1 cull tile
VIS_CAP = 128  # candidate clusters kept per tile
BLOCK = 256  # ray slots per pair block
_INF = 3e38  # the combine's "no hit"
_BIG_TRI = 2 ** 30


def _tiles_per_chunk(device: torch.device) -> int:
    """Tiles of one level-2 chunk: 256 x VIS_CAP lanes per tile, 134 MB
    per float32 temporary on the card."""
    return 64 if device.type == "cpu" else 1024


def enumerate_pairs(wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Dense candidate enumeration: pair (ray r, cluster c) iff ray r
    enters c's AABB within [t_min, t_max(r)). Returns (pair_ray,
    pair_leaf, pair_valid, overflow), P = PAIR_CAP_PER_RAY * R pairs
    grouped by leaf (ascending leaf, then ray), invalid pairs last with
    leaf C; overflow is True when more than P pairs were found."""
    R, C = ray_o.shape[0], wc_min.shape[0]
    dev = ray_o.device
    inv = safe_inv_dir(ray_d)
    t0 = (wc_min[:, None, :] - ray_o[None]) * inv[None]
    t1 = (wc_max[:, None, :] - ray_o[None]) * inv[None]
    lo = torch.minimum(t0, t1).amax(-1)
    hi = torch.maximum(t0, t1).amin(-1)
    entry = torch.clamp_min(lo, float(t_min))
    t_max = trace_bvh.as_tmax(t_max, R, dev)
    flat = ((hi >= entry) & (entry < t_max[None, :])).reshape(C * R)
    P = PAIR_CAP_PER_RAY * R
    pos = torch.cumsum(flat, 0) - 1
    ids = torch.full((P + 1,), C * R, dtype=torch.int64, device=dev)
    ids.scatter_(0, torch.where(flat & (pos < P), pos, P),
                 torch.arange(C * R, device=dev))
    ids = ids[:P]
    valid = ids < C * R
    pair_leaf = torch.where(valid, ids // R, C).to(torch.int32)
    pair_ray = torch.where(valid, ids % R, 0).to(torch.int32)
    return pair_ray, pair_leaf, valid, flat.sum() > P


def candidate_lists(wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Per-ray candidate clusters by the two-level cull. Returns
    (ray_leaf (Rpad, K) int32, ascending cluster ids, C where empty;
    heavy (Rpad,) bool, the rays with more than K candidates or in a
    tile with more than VIS_CAP; tile_overflow, a 0-d bool: some tile
    had more than VIS_CAP), Rpad = R rounded up to ENUM_TILE. The pad
    rays have ray 0's origin, a zero direction and t_max 0 (:115-122),
    so they widen no packet and enter nothing."""
    R0, C = ray_o.shape[0], wc_min.shape[0]
    dev = ray_o.device
    t_max = trace_bvh.as_tmax(t_max, R0, dev)
    pad = (-R0) % ENUM_TILE
    if pad:
        ray_o = torch.cat([ray_o, ray_o[:1].expand(pad, 3)])
        ray_d = torch.cat([ray_d, torch.zeros((pad, 3), dtype=ray_d.dtype,
                                              device=dev)])
        t_max = torch.cat([t_max, torch.zeros(pad, dtype=torch.float32,
                                              device=dev)])
    R = R0 + pad
    T = R // ENUM_TILE
    o_t = ray_o.reshape(T, ENUM_TILE, 3)
    d_t = ray_d.reshape(T, ENUM_TILE, 3)
    tm_t = t_max.reshape(T, ENUM_TILE)

    # level 1: each tile's first V overlapping clusters, ascending (the
    # head of the Pallas code's stable argsort of ~overlap): the v-th is
    # where the running count of overlaps first reaches v + 1
    overlap = packet_aabb_overlap_2d(
        o_t.amin(1), o_t.amax(1), d_t.amin(1), d_t.amax(1), wc_min, wc_max,
        tm_t.amax(1))
    seen = torch.cumsum(overlap, 1, dtype=torch.float32)  # exact below 2^24
    cand_count = seen[:, -1]
    V = min(VIS_CAP, C)
    cand = torch.searchsorted(seen, _counts_to(V, (T,), dev))
    cand = torch.clamp_max(cand, C - 1)
    cand_ok = torch.arange(V, device=dev)[None, :] < cand_count[:, None]

    # level 2: the exact slab test of each ray against its tile's
    # candidates; the first K entered ones, ascending, found the same way
    K = PAIR_CAP_PER_RAY
    inv_t = safe_inv_dir(d_t)
    # running counts along the V candidates as one product with an upper
    # triangle of ones: exact (sums of at most V ones), and far quicker on
    # the card than a scan along a 128-wide last dimension
    upper = torch.ones((V, V), device=dev).triu()
    ray_leaf = torch.full((R, K), C, dtype=torch.int32, device=dev)
    heavy = torch.empty((R,), dtype=torch.bool, device=dev)
    step = _tiles_per_chunk(dev)
    for a in range(0, T, step):
        b = min(T, a + step)
        cmin, cmax = wc_min[cand[a:b]], wc_max[cand[a:b]]  # (n, V, 3)
        o, inv = o_t[a:b, :, None, :], inv_t[a:b, :, None, :]
        lo = torch.full((b - a, ENUM_TILE, V), -_INF, device=dev)
        hi = torch.full((b - a, ENUM_TILE, V), _INF, device=dev)
        for ax in range(3):
            s0 = (cmin[:, None, :, ax] - o[..., ax]) * inv[..., ax]
            s1 = (cmax[:, None, :, ax] - o[..., ax]) * inv[..., ax]
            lo = torch.maximum(lo, torch.minimum(s0, s1))
            hi = torch.minimum(hi, torch.maximum(s0, s1))
        entry = torch.clamp_min(lo, float(t_min))
        enter = ((hi >= entry) & (entry < tm_t[a:b, :, None])
                 & cand_ok[a:b, None, :])
        seen = enter.float() @ upper
        j = torch.searchsorted(seen, _counts_to(K, (b - a, ENUM_TILE), dev))
        leaves = torch.gather(cand[a:b], 1, torch.clamp_max(j, V - 1)
                              .reshape(b - a, ENUM_TILE * K))
        rows = slice(a * ENUM_TILE, b * ENUM_TILE)
        ray_leaf[rows] = torch.where(j < V, leaves.reshape(j.shape),
                                     C).reshape(-1, K).to(torch.int32)
        heavy[rows] = (seen[..., -1] > K).reshape(-1)
    heavy |= (cand_count > V).repeat_interleave(ENUM_TILE)
    return ray_leaf, heavy, (cand_count > V).any()


def _counts_to(n: int, lead: tuple, device) -> torch.Tensor:
    """1, 2, ..., n (float32) broadcast to lead + (n,), contiguous: the
    running counts whose first positions searchsorted finds."""
    return torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(
        *lead, n).contiguous()


def pairs_from_lists(ray_leaf, n_clusters: int):
    """(Rpad, K) candidate lists -> leaf-major (pair_ray, pair_leaf,
    pair_valid), P = Rpad * K pairs: one stable sort of the leaf ids, the
    invalid pairs (leaf C) last."""
    K = ray_leaf.shape[1]
    pair_leaf, perm = torch.sort(ray_leaf.reshape(-1), stable=True)
    return (perm // K).to(torch.int32), pair_leaf, pair_leaf < n_clusters


def enumerate_pairs_tiled(wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """The tiled enumeration with enumerate_pairs' contract; overflow
    covers both heavy rays and tiles over VIS_CAP."""
    ray_leaf, heavy, tile_overflow = candidate_lists(
        wc_min, wc_max, ray_o, ray_d, t_min, t_max)
    pairs = pairs_from_lists(ray_leaf, wc_min.shape[0])
    return (*pairs, heavy.any() | tile_overflow)


def build_blocks(pair_ray, pair_leaf, pair_valid, n_clusters: int):
    """Leaf-grouped pairs -> 256-slot blocks of one leaf each: (block_leaf
    (B,) int32, -1 for an empty block; slot_ray (B, 256) int32; slot_valid
    (B, 256) bool; pair_block (P,); pair_slot (P,)), B = P // 256 +
    n_clusters, the most a leaf-grouped list can fill."""
    P = pair_ray.shape[0]
    B = P // BLOCK + n_clusters
    dev = pair_ray.device
    leaf = torch.where(pair_valid, pair_leaf, n_clusters).long()
    idx = torch.arange(P, device=dev)
    is_start = torch.ones((P,), dtype=torch.bool, device=dev)
    is_start[1:] = leaf[1:] != leaf[:-1]
    # rank within the leaf's segment: the pair's index less its segment's
    # first index (:245-248 take a running max of the starts instead)
    seg = torch.cumsum(is_start, 0) - 1
    first = _scatter_at(P, torch.where(is_start, seg, -1), idx)
    w = idx - first[seg]
    opens = (is_start | (w % BLOCK == 0)) & pair_valid
    block_of = torch.where(pair_valid, torch.cumsum(opens, 0) - 1, B - 1)
    slot = w % BLOCK
    # each block is opened by one pair and each valid (block, slot) is
    # one pair's, so plain scatters give the maxima of :257-271
    block_leaf = _scatter_at(B, torch.where(opens, block_of, -1),
                             leaf.to(torch.int32), fill=-1)
    flat = torch.where(pair_valid, block_of * BLOCK + slot, -1)
    slot_ray = _scatter_at(B * BLOCK, flat, pair_ray.to(torch.int32))
    slot_valid = _scatter_at(B * BLOCK, flat, pair_valid)
    return (block_leaf, slot_ray.reshape(B, BLOCK),
            slot_valid.reshape(B, BLOCK), block_of, slot)


def _scatter_at(n: int, dst, src, fill=0, reduce=None):
    """out (n,) = fill, then src[i] written at dst[i] where dst[i] >= 0:
    stored (reduce None; each target written once or with equal values)
    or combined by scatter_reduce_(reduce). The entries with dst < 0
    (most of the P pairs or B x 256 slots are empty) go to a spill region
    past n, one place each, so no store or atomic waits on one shared
    address."""
    spill = n + torch.arange(dst.shape[0], device=dst.device)
    out = torch.full((n + dst.shape[0],), fill, dtype=src.dtype,
                     device=dst.device)
    at = torch.where(dst >= 0, dst, spill)
    if reduce is None:
        return out.scatter_(0, at, src)[:n]
    return out.scatter_reduce_(0, at, src, reduce)[:n]


# ---------------------------------------------------------------------------
# K14 and its plain version


def run_pairs_plain(slabs, block_leaf, slot_ray, slot_valid, ray_o, ray_d,
                    t_min, t_max, any_hit: bool):
    """Möller of every block's valid slots against its leaf's slab.

    any_hit=False -> (B, 4, 256) f32 rows t | tri | u | v per slot: the
    slot's nearest hit (t_min < t < t_max of its ray), the lowest lane
    among equal t; a slot without a hit has t = 3e38, tri = -1, u = v =
    0. any_hit=True -> (B, 256) bool occlusion. Blocks of leaf -1 hold no
    valid slot."""
    B = block_leaf.shape[0]
    dev = ray_o.device
    t_max = trace_bvh.as_tmax(t_max, ray_o.shape[0], dev)
    live = slot_valid & (block_leaf >= 0)[:, None]
    if any_hit:
        out = torch.zeros((B, BLOCK), dtype=torch.bool, device=dev)
    else:
        out = torch.zeros((B, 4, BLOCK), dtype=torch.float32, device=dev)
        out[:, 0] = _INF
        out[:, 1] = -1.0
    blocks = torch.nonzero(block_leaf >= 0).flatten()
    lanes = torch.arange(CLUSTER_PAD, device=dev)
    step = 16 if dev.type == "cpu" else 512
    for a in range(0, blocks.shape[0], step):
        bi = blocks[a:a + step]
        leaf = block_leaf[bi].long()
        s = slabs[leaf, 0:ROWS_PLAIN, :].transpose(1, 2)[:, None]  # (n,1,128,9)
        ray = slot_ray[bi].long()
        ok = live[bi]
        hit, t, u, v = moller_trumbore(
            ray_o[ray][:, :, None, :], ray_d[ray][:, :, None, :],
            s[..., 0:3], s[..., 3:6], s[..., 6:9], float(t_min),
            torch.where(ok, t_max[ray], 0.0)[..., None])
        hit = hit & ok[..., None]
        if any_hit:
            out[bi] = hit.any(-1)
            continue
        t = torch.where(hit, t, float("inf"))
        best = t.amin(-1)
        j = torch.where(t == best[..., None], lanes, CLUSTER_PAD).amin(-1)
        j = torch.clamp_max(j, CLUSTER_PAD - 1)
        found = torch.isfinite(best)
        uj = torch.gather(u, 2, j[..., None])[..., 0]
        vj = torch.gather(v, 2, j[..., None])[..., 0]
        out[bi] = torch.stack([
            torch.where(found, best, _INF),
            torch.where(found, (leaf[:, None] * CLUSTER_PAD + j).float(), -1.0),
            torch.where(found, uj, 0.0),
            torch.where(found, vj, 0.0),
        ], dim=1)
    return out


# the C entry point's arguments before the stream (cuda_build.launch)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p]


def run_pairs(slabs, block_leaf, slot_ray, slot_valid, ray_o, ray_d, t_min,
              t_max, any_hit: bool):
    """K14: the pair blocks' Möller, run_pairs_plain's contract.

    slabs (C, >=9, 128) f32; block_leaf (B,) int32; slot_ray (B, 256)
    int32; slot_valid (B, 256) bool; ray_o, ray_d (R, 3) f32; t_max
    scalar or (R,)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_max = trace_bvh.as_tmax(t_max, R, dev)
    if dev.type == "cpu":
        return run_pairs_plain(slabs, block_leaf, slot_ray, slot_valid, ray_o,
                               ray_d, float(t_min), t_max, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"run_pairs: unsupported device {dev}")
    B = block_leaf.shape[0]
    expect = trace_bvh.expect_tensor
    expect(slabs, "slabs", torch.float32, dev, (None, None, CLUSTER_PAD))
    if slabs.shape[1] < ROWS_PLAIN:
        raise ValueError(f"slabs need >= {ROWS_PLAIN} rows, got "
                         f"{slabs.shape[1]}")
    expect(block_leaf, "block_leaf", torch.int32, dev, (B,))
    expect(slot_ray, "slot_ray", torch.int32, dev, (B, BLOCK))
    expect(slot_valid, "slot_valid", torch.bool, dev, (B, BLOCK))
    expect(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect(ray_d, "ray_d", torch.float32, dev, (R, 3))
    if any_hit:
        out = torch.empty((B, BLOCK), dtype=torch.bool, device=dev)
    else:
        out = torch.empty((B, 4, BLOCK), dtype=torch.float32, device=dev)
    from . import cuda_build

    cuda_build.launch("trace_leafmajor", "run_pairs", _ARGTYPES, dev, (
        slabs.data_ptr(), slabs.shape[1], block_leaf.data_ptr(), B,
        slot_ray.data_ptr(), slot_valid.data_ptr(), ray_o.data_ptr(),
        ray_d.data_ptr(), t_max.data_ptr(), float(t_min), int(any_hit),
        out.data_ptr()))
    run_pairs.launches += 1
    return out


run_pairs.launches = 0
KERNELS = (run_pairs,)


# ---------------------------------------------------------------------------
# The per-ray combine and the tracers


def closest_from_pairs(slabs, pair_ray, pair_leaf, pair_valid, n_clusters,
                       R, ray_o, ray_d, t_min, t_max):
    """Leaf-grouped pairs -> blocks -> K14 -> per ray the smallest t, then
    the lowest tri, with that triangle's u, v: dict(t, tri, u, v), t =
    inf and tri = -1 on a miss (:487-537)."""
    block_leaf, slot_ray, slot_valid, _, _ = build_blocks(
        pair_ray, pair_leaf, pair_valid, n_clusters)
    out = run_pairs(slabs, block_leaf, slot_ray, slot_valid, ray_o, ray_d,
                    t_min, t_max, any_hit=False)
    valid = slot_valid.reshape(-1)
    ray = slot_ray.reshape(-1).long()  # 0 on an invalid slot
    t_blk = out[:, 0].reshape(-1)  # 3e38 where a slot has no hit
    best_t = _scatter_at(R, torch.where(valid, ray, -1), t_blk, _INF, "amin")
    tri_blk = out[:, 1].reshape(-1).long()
    is_best = valid & (t_blk <= best_t[ray]) & (t_blk < _INF)
    best_tri = _scatter_at(R, torch.where(is_best, ray, -1), tri_blk,
                           _BIG_TRI, "amin")
    at = torch.where(is_best & (tri_blk == best_tri[ray]), ray, -1)

    def pick(row):
        return _scatter_at(R, at, out[:, row].reshape(-1))

    miss = best_t >= _INF
    return {
        "t": torch.where(miss, float("inf"), best_t),
        "tri": torch.where(miss, -1, best_tri).to(torch.int32),
        "u": pick(2),
        "v": pick(3),
    }


def any_from_pairs(slabs, pair_ray, pair_leaf, pair_valid, n_clusters, R,
                   ray_o, ray_d, t_min, t_max):
    """Leaf-grouped pairs -> blocks -> K14 -> (R,) bool, the OR over each
    ray's slots (:564-581)."""
    block_leaf, slot_ray, slot_valid, _, _ = build_blocks(
        pair_ray, pair_leaf, pair_valid, n_clusters)
    occ_blk = run_pairs(slabs, block_leaf, slot_ray, slot_valid, ray_o,
                        ray_d, t_min, t_max, any_hit=True)
    hit = (occ_blk & slot_valid).reshape(-1)
    return _scatter_at(R, torch.where(hit, slot_ray.reshape(-1).long(), -1),
                       hit)


def trace_closest_leafmajor(slabs, wc_min, wc_max, ray_o, ray_d, t_min,
                            t_max):
    """Closest hit over every ray's first K candidates: dict(t, tri, u, v)
    (t = inf on a miss) and "_overflow", True when some ray had more
    candidates or some tile more than VIS_CAP (then the result may miss
    hits)."""
    pair_ray, pair_leaf, pair_valid, overflow = enumerate_pairs_tiled(
        wc_min, wc_max, ray_o, ray_d, t_min, t_max)
    hit = closest_from_pairs(slabs, pair_ray, pair_leaf, pair_valid,
                             wc_min.shape[0], ray_o.shape[0], ray_o, ray_d,
                             t_min, t_max)
    hit["_overflow"] = overflow
    return hit


def trace_any_leafmajor(slabs, wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """Any hit over every ray's first K candidates -> ((R,) bool,
    overflow)."""
    pair_ray, pair_leaf, pair_valid, overflow = enumerate_pairs_tiled(
        wc_min, wc_max, ray_o, ray_d, t_min, t_max)
    occ = any_from_pairs(slabs, pair_ray, pair_leaf, pair_valid,
                         wc_min.shape[0], ray_o.shape[0], ray_o, ray_d,
                         t_min, t_max)
    return occ, overflow


def light_pairs(wc_min, wc_max, ray_o, ray_d, t_min, t_max):
    """The hybrid's split: (heavy (R,) bool, the light rays' leaf-grouped
    pairs (pair_ray, pair_leaf, pair_valid), tile_overflow)."""
    C = wc_min.shape[0]
    ray_leaf, heavy, tile_overflow = candidate_lists(
        wc_min, wc_max, ray_o, ray_d, t_min, t_max)
    ray_leaf = torch.where(heavy[:, None], C, ray_leaf)  # light rays only
    return (heavy[:ray_o.shape[0]], pairs_from_lists(ray_leaf, C),
            tile_overflow)


def trace_closest_hybrid(slabs, bvh_bounds, bvh_meta, wc_min, wc_max, ray_o,
                         ray_d, t_min, t_max):
    """Closest hit: light rays through the pair blocks (K14), heavy rays
    through K2 over the BVH, every light ray disabled there by t_max = 0.
    Exact. Returns (dict(t, tri, u, v), t = inf on a miss;
    tile_overflow)."""
    R = ray_o.shape[0]
    t_max = trace_bvh.as_tmax(t_max, R, ray_o.device)
    heavy, pairs, tile_overflow = light_pairs(wc_min, wc_max, ray_o, ray_d,
                                              t_min, t_max)
    h_lm = closest_from_pairs(slabs, *pairs, wc_min.shape[0], R, ray_o,
                              ray_d, t_min, t_max)
    h_pk = unpack_hit8(trace_bvh.trace_closest_bvh(
        slabs, bvh_bounds, bvh_meta, ray_o, ray_d, t_min,
        torch.where(heavy, t_max, 0.0)))
    hit = {k: torch.where(heavy, h_pk[k], h_lm[k])
           for k in ("t", "tri", "u", "v")}
    # K2 reports a miss as t = t_max
    hit["t"] = torch.where(hit["tri"] < 0, float("inf"), hit["t"])
    return hit, tile_overflow


def trace_any_hybrid(slabs, bvh_bounds, bvh_meta, wc_min, wc_max, ray_o,
                     ray_d, t_min, t_max):
    """Any hit, hybrid as trace_closest_hybrid with K3 for the heavy rays.
    Returns ((R,) bool, tile_overflow)."""
    R = ray_o.shape[0]
    t_max = trace_bvh.as_tmax(t_max, R, ray_o.device)
    heavy, pairs, tile_overflow = light_pairs(wc_min, wc_max, ray_o, ray_d,
                                              t_min, t_max)
    occ_lm = any_from_pairs(slabs, *pairs, wc_min.shape[0], R, ray_o, ray_d,
                            t_min, t_max)
    occ_pk = trace_bvh.trace_any_bvh(slabs, bvh_bounds, bvh_meta, ray_o,
                                     ray_d, t_min,
                                     torch.where(heavy, t_max, 0.0))
    return torch.where(heavy, occ_pk, occ_lm), tile_overflow


def trace_closest_leafmajor_safe(slabs, bvh_bounds, bvh_meta, wc_min, wc_max,
                                 ray_o, ray_d, t_min, t_max):
    """The exact closest hit of the hybrid -> dict(t, tri, u, v)."""
    hit, _ = trace_closest_hybrid(slabs, bvh_bounds, bvh_meta, wc_min,
                                  wc_max, ray_o, ray_d, t_min, t_max)
    return hit


def trace_any_leafmajor_safe(slabs, bvh_bounds, bvh_meta, wc_min, wc_max,
                             ray_o, ray_d, t_min, t_max):
    """The exact any hit of the hybrid -> (R,) bool."""
    occ, _ = trace_any_hybrid(slabs, bvh_bounds, bvh_meta, wc_min, wc_max,
                              ray_o, ray_d, t_min, t_max)
    return occ


def trace_closest_leafmajor_full_safe(slabs_full, bvh_bounds, bvh_meta,
                                      wc_min, wc_max, ray_o, ray_d, t_min,
                                      t_max):
    """The exact closest hit with the attribute set of K4's rows."""
    return attrs_from_hit(slabs_full, trace_closest_leafmajor_safe(
        slabs_full, bvh_bounds, bvh_meta, wc_min, wc_max, ray_o, ray_d,
        t_min, t_max))


def attrs_from_hit(slabs_full, hit: dict) -> dict:
    """The full hit dict at (tri, u, v): rows 9-37 of the hit triangle's
    lane in the (C, 40, 128) slabs, blended w*a0 + u*a1 + v*a2, zero
    attributes on a miss; the same set as slabs.attrs_from_hit_rows."""
    tri = torch.clamp_min(hit["tri"], 0).long()
    a = slabs_full[tri // CLUSTER_PAD, ROWS_PLAIN:38, tri % CLUSTER_PAD]
    u, v = hit["u"][:, None], hit["v"][:, None]
    w = 1.0 - u - v
    normal = w * a[:, 0:3] + u * a[:, 3:6] + v * a[:, 6:9]
    tangent = w * a[:, 9:13] + u * a[:, 13:17] + v * a[:, 17:21]
    uv = w * a[:, 21:23] + u * a[:, 23:25] + v * a[:, 25:27]
    miss = hit["tri"] < 0
    return {
        "t": hit["t"],
        "tri": hit["tri"],
        "normal": torch.where(miss[:, None], 0.0, normal),
        "tangent": torch.where(miss[:, None], 0.0, tangent),
        "uv": torch.where(miss[:, None], 0.0, uv),
        "material": torch.where(miss, 0, a[:, 27].to(torch.int32)),
        "tri_lod": torch.where(miss, 0.0, a[:, 28]),
    }
