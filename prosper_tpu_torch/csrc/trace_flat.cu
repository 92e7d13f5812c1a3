// Flat cull-list ray-trace kernels for Hopper (sm_90a): the port of the
// three Pallas TPU kernels that trace without BVH node arrays.
//
//   trace_closest_flat       replaces prosper_tpu/ops/trace_pallas.py
//                            trace_closest_pallas (:272): closest hit over
//                            per-tile cluster lists, (R, 8) rows.
//   trace_closest_flat_full  replaces prosper_tpu/ops/trace_pallas_full.py
//                            trace_closest_full (:255): the same hit and
//                            the winning triangle's interpolated
//                            attributes, (R, 16) rows.
//   trace_any_flat           replaces trace_pallas.py trace_any_pallas
//                            (:396, kernel _any_kernel :332): any hit over
//                            the same lists, (R,) occlusion.
//
// Contract (prosper_tpu_torch/ops/trace_flat.py): the closest hit of
// each ray, t_min < t < t_max (per ray), over every cluster whose AABB
// (wc_min, wc_max (C, 3)) the ray enters. A masked cluster has an
// inverted AABB (min 3e38, max -3e38) that no ray enters. Slabs (C,
// rows, 128) f32, rows 0-8 = v0|e1|e2 and, for the full kernel, rows
// 9-37 the attributes (ops/slabs.py). t_min is honoured: the Pallas
// kernels hard-code 1e-4. Exact t ties go to the lowest triangle id, as
// in the plain version, so the walk order does not change the result.
//
// Design of K6 and K8: one block of 256 threads per 256 consecutive
// rays, a tile (callers trace 16x16 pixel blocks). The block
// 1. reduces its rays to packet bounds (origin and direction boxes, the
//    largest t_max); a tile with no t_max above t_min writes misses;
// 2. culls all C cluster AABBs against the packet with the interval slab
//    test of ops/intersect.packet_aabb_enter_exit (inverted boxes never
//    overlap) and compacts the survivors, in id order, into a list in
//    shared memory (a ballot and a prefix over warps);
// 3. sorts the list front to back by the packet's entry distance (ties
//    by id; a bitonic sort in shared memory), the order of
//    trace_pallas._cull_lists, unless it is in that order already: an
//    incoherent tile's packet entry is 0 for every cluster;
// 4. bounds each run of 32 list entries by a chunk box, the exact union
//    of their AABBs (one warp a chunk). A box holds its members and the
//    slab test rounds monotonically in the box, so a ray that does not
//    enter the chunk box enters none of its clusters;
// 5. walks the list warp by warp, with no block barrier (no thread writes
//    shared memory after step 4), chunk by chunk. The lanes whose own ray
//    enters the chunk box before their best hit own it. With more owners
//    than entries (a coherent tile) the warp goes entry by entry: each
//    owner tests its ray's slab entry into the cluster's AABB. Otherwise
//    it goes owner by owner, lowest lane first: lane l tests the owner's
//    ray against entry 32j + l, and the entries it enters are taken in
//    list order. Each way costs the warp one slab-test round per owner
//    or per entry, so it takes the fewer. Either way a cluster the
//    ray enters (enter <= exit, enter < t_max) no later than its best
//    hit (inclusive: a hit at exactly `best` with a lower triangle id
//    still wins) is tested with the whole warp: lane l takes triangles
//    l + 32q on full 128-byte slab lines read from device memory
//    (flat_leaf), and the owner keeps the lowest (t, triangle id) of the
//    warp. A warp leaves the list once the next key, a packet entry,
//    lies beyond the best hit of each of its live lanes (the
//    front-to-back exit of trace_pallas.py:165-169): a ray's own entry is
//    never below its packet's, so no later cluster can hold a hit for it;
// 6. each lane recomputes u, v of its final hit once (the same Möller
//    test on the same inputs), and the full kernel reads rows 9-37 of the
//    winning triangle once.
// Exact t ties go to the lowest triangle id over all clusters, not to
// the cluster tested first (the warp walk of csrc/trace_bvh.cu keeps the
// earlier visit; the flat list is ordered by packet entry, not by id),
// so the rows equal the plain version's bit for bit in any walk order.
//
// The any-hit kernel (K7) runs steps 1, 2, 4 and the walk of step 5 on
// the same lists, in id order (the order is free for an any hit, so step
// 3 is left out), with the owner test "enters the box before t_max"
// (enter <= exit, enter < t_max) in place of "before the best hit". A
// lane is live while it is active, has t_max above t_min (else no hit
// can occlude it) and is not yet occluded; the warp tests each entered
// cluster together (ray_common.cuh warp_any, K3's and K10's test: lane
// l takes triangles l + 32q, and __any_sync decides), an occluded owner
// takes none of its pending entries, and the warp leaves the list once
// no lane is live. The mask equals the plain version's bit for bit in
// any ray order.
//
// The list holds the next power of two above C entries (8 KB of ids and
// 8 KB of keys at C = 2048) and 24 bytes of chunk box for every 32
// entries; the host side refuses a C whose list does not fit in the
// 227 KB of shared memory a block can have (C <= 16384), so no
// overlapping cluster is ever dropped.
//
// What bounds the three on the H100: on an incoherent tile (up to C
// listed clusters, each ray entering a few), the chunk tests (C / 32 a
// lane) and the owner-by-owner entry tests of the chunks a ray enters;
// on a coherent one, the Möller tests (53 float operations each, 4 a
// lane for each cluster an owner enters before its hit, or for K7 before
// its first occluder). The slab reads are coalesced lines shared through
// L2 by the tile's rays. The Möller test is ray_common.cuh's, operation
// for operation the plain PyTorch version (built with --fmad=false), so
// hits agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define TILE 256      // rays per block
#define WARPS (TILE / 32)
#define CHUNK 32      // list entries under one chunk box
#define MIN_BLOCKS 4  // blocks an SM must hold: <= 64 registers
#define BIG 3e38f     // entry / exit of a box no packet overlaps
#define MAX_SHARED 232448  // dynamic shared memory a block can have

namespace {

// One axis of ops/intersect.packet_aabb_enter_exit.
__device__ __forceinline__ void packet_axis(float olo, float ohi, float dlo,
                                            float dhi, float bmin, float bmax,
                                            float& en, float& ex) {
    bool uni = dlo > 0.0f || dhi < 0.0f;
    float ia = uni ? 1.0f / dhi : 0.0f;
    float ib = uni ? 1.0f / dlo : 0.0f;
    float lo0 = bmin - ohi, hi0 = bmin - olo;
    float lo1 = bmax - ohi, hi1 = bmax - olo;
    float mn0 = fminf(fminf(lo0 * ia, lo0 * ib), fminf(hi0 * ia, hi0 * ib));
    float mn1 = fminf(fminf(lo1 * ia, lo1 * ib), fminf(hi1 * ia, hi1 * ib));
    float mx0 = fmaxf(fmaxf(lo0 * ia, lo0 * ib), fmaxf(hi0 * ia, hi0 * ib));
    float mx1 = fmaxf(fmaxf(lo1 * ia, lo1 * ib), fmaxf(hi1 * ia, hi1 * ib));
    en = uni ? fminf(mn0, mn1) : -BIG;
    ex = uni ? fmaxf(mx0, mx1) : BIG;
}

// Per-ray slab test of box c (ops/intersect.slab_enter_exit).
__device__ __forceinline__ void ray_box(const float* __restrict__ wc_min,
                                        const float* __restrict__ wc_max,
                                        int c, const Ray& r, float& en,
                                        float& ex) {
    const float* a = wc_min + 3 * c;
    const float* b = wc_max + 3 * c;
    en = slab_enter(__ldg(a), __ldg(a + 1), __ldg(a + 2), __ldg(b),
                    __ldg(b + 1), __ldg(b + 2), r, ex);
}

template <bool FULL>
__device__ __forceinline__ void write_row(const float* __restrict__ slabs,
                                          int rows, int k, float t, int tri,
                                          float u, float v,
                                          float* __restrict__ out) {
    if (FULL) {
        write_full(slabs, rows, t, tri, u, v, out + 16 * (size_t)k);
        return;
    }
    float* o = out + 8 * (size_t)k;
    o[0] = t;
    o[1] = (float)tri;
    o[2] = u;
    o[3] = v;
    o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// (key, id) lexicographic order of the list.
__device__ __forceinline__ bool after(float ka, int ia, float kb, int ib) {
    return ka > kb || (ka == kb && ia > ib);
}

// Chunk boxes of a list of n entries.
__host__ __device__ __forceinline__ int chunks(int n) {
    return (n + CHUNK - 1) / CHUNK;
}

// Step 1: the block's packet bounds, min o | max o | min d | max d | max
// t_max, into s_pkt[13].
__device__ __forceinline__ void packet_bounds(const Ray& r, float tmax_ray,
                                              float (*s_red)[WARPS],
                                              float* s_pkt) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float b[13] = {r.ox, r.oy, r.oz, r.ox, r.oy, r.oz,
                   r.dx, r.dy, r.dz, r.dx, r.dy, r.dz, tmax_ray};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 13; ++i) {
            float o = __shfl_xor_sync(0xffffffffu, b[i], off);
            bool is_min = i < 3 || (i >= 6 && i < 9);
            b[i] = is_min ? fminf(b[i], o) : fmaxf(b[i], o);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 13; ++i) s_red[i][warp] = b[i];
    }
    __syncthreads();
    if (tid < 13) {
        bool is_min = tid < 3 || (tid >= 6 && tid < 9);
        float m = s_red[tid][0];
        for (int w = 1; w < WARPS; ++w)
            m = is_min ? fminf(m, s_red[tid][w]) : fmaxf(m, s_red[tid][w]);
        s_pkt[tid] = m;
    }
    __syncthreads();
}

// Step 2: the packet cull of every cluster, compacted in id order into
// (s_key, s_id); returns the list's length.
__device__ __forceinline__ int cull_clusters(
    int C, const float* __restrict__ wc_min, const float* __restrict__ wc_max,
    const float* s_pkt, float tile_tmax, float* s_key, int* s_id,
    int* s_wcount) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int count = 0;
    for (int base = 0; base < C; base += TILE) {
        const int c = base + tid;
        bool ok = false;
        float key = 0.0f;
        if (c < C) {
            float en[3], ex[3];
            bool invalid = false;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                float lo = __ldg(wc_min + 3 * c + a);
                float hi = __ldg(wc_max + 3 * c + a);
                invalid |= lo > hi;
                packet_axis(s_pkt[a], s_pkt[3 + a], s_pkt[6 + a], s_pkt[9 + a],
                            lo, hi, en[a], ex[a]);
            }
            float enter = fmaxf(fmaxf(en[0], en[1]), en[2]);
            float exit_ = fminf(fminf(ex[0], ex[1]), ex[2]);
            if (invalid) {
                enter = BIG;
                exit_ = -BIG;
            }
            ok = enter <= exit_ && exit_ >= 0.0f && enter <= tile_tmax;
            key = fmaxf(enter, 0.0f);
        }
        unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) s_wcount[warp] = __popc(bal);
        __syncthreads();
        int off = count, total = 0;
        for (int w = 0; w < WARPS; ++w) {
            int n = s_wcount[w];
            off += w < warp ? n : 0;
            total += n;
        }
        if (ok) {
            int pos = off + __popc(bal & ((1u << lane) - 1u));
            s_key[pos] = key;
            s_id[pos] = c;
        }
        count += total;
        __syncthreads();  // s_wcount is rewritten by the next chunk
    }
    return count;
}

// Step 4: the chunk boxes of a list of `count` entries, the union of
// the AABBs of entries 32j .. 32j + 31, min and max taken exactly, one
// warp a chunk, into s_cbox (6 rows of cstride).
__device__ __forceinline__ void chunk_boxes(int count,
                                            const float* __restrict__ wc_min,
                                            const float* __restrict__ wc_max,
                                            const int* s_id, float* s_cbox,
                                            int cstride) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = warp; j < chunks(count); j += WARPS) {
        const int e = CHUNK * j + lane;
        float b[6] = {INF, INF, INF, -INF, -INF, -INF};
        if (e < count) {
            const int c = s_id[e];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                b[a] = __ldg(wc_min + 3 * c + a);
                b[3 + a] = __ldg(wc_max + 3 * c + a);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                b[a] = fminf(b[a], __shfl_xor_sync(FULL_MASK, b[a], off));
                b[3 + a] =
                    fmaxf(b[3 + a], __shfl_xor_sync(FULL_MASK, b[3 + a], off));
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int a = 0; a < 6; ++a) s_cbox[a * cstride + j] = b[a];
        }
    }
}

// The block's ray: lanes past R take the tile's first ray, so the packet
// bounds are those of the tile's rays alone.
__device__ __forceinline__ Ray tile_ray(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        int src) {
    Ray r;
    r.ox = ray_o[3 * src];
    r.oy = ray_o[3 * src + 1];
    r.oz = ray_o[3 * src + 2];
    r.dx = ray_d[3 * src];
    r.dy = ray_d[3 * src + 1];
    r.dz = ray_d[3 * src + 2];
    set_inv(r);
    return r;
}

// The warp-shared test of one listed cluster c (K6, K8). Every lane of
// the warp calls it with the same c and src, the owner: lane src's ray,
// with t_upper = its t_max and its best hit (best, best_tri), is tested
// against the cluster's 128 triangles, lane l taking triangles l + 32q
// (q = 0..3), every slab load one full 128-byte line across the warp.
// A lane keeps a triangle whose (t, id) lies below the owner's (best,
// best_tri) and below the lane's earlier ones, t compared as floats (-0
// equals +0); the warp takes the least t key, then the least id among
// the lanes at that key, and the owner takes its t and id (the kernel
// computes u, v of the final hit once, at the end). That is the lowest
// (t, id) of the owner's hits and the hits of the clusters it tested
// before, the hit the plain version's minimum over all entered clusters
// gives, whatever the list's order.
__device__ __forceinline__ void flat_leaf(const float* __restrict__ slabs,
                                          int rows, int c, int src,
                                          const Ray& r, float tmax_ray,
                                          float t_min, float& best,
                                          int& best_tri) {
    const int lane = threadIdx.x & 31;
    const Ray q = owner_ray(r, src);
    const float t_upper = __shfl_sync(FULL_MASK, tmax_ray, src);
    float bt = __shfl_sync(FULL_MASK, best, src);
    int btri = __shfl_sync(FULL_MASK, best_tri, src);
    bool found = false;
    const float* s = slabs + (size_t)c * rows * LANES + lane;
#pragma unroll
    for (int j = 0; j < LANES; j += 32) {
        float t, u, v;
        const int tri = c * LANES + lane + j;
        if (moller(s, j, q, t_min, t_upper, t, u, v) &&
            (t < bt || (t == bt && tri < btri))) {
            bt = t;
            btri = tri;
            found = true;
        }
    }
    const unsigned key = found ? t_key(bt) : NO_KEY;
    const unsigned kmin = __reduce_min_sync(FULL_MASK, key);
    if (kmin == NO_KEY) return;
    const unsigned tri =
        __reduce_min_sync(FULL_MASK, key == kmin ? (unsigned)btri : NO_KEY);
    const float t = __shfl_sync(FULL_MASK, bt, (int)(tri & 31u));
    if (lane == src) {
        best = t;
        best_tri = (int)tri;
    }
}

// K6 (FULL = false, (R, 8) rows) and K8 (FULL = true, (R, 16) rows).
template <bool FULL>
__global__ void __launch_bounds__(TILE, MIN_BLOCKS)
flat_kernel(const float* __restrict__ slabs, int rows, int C,
            const float* __restrict__ wc_min, const float* __restrict__ wc_max,
            const float* __restrict__ ray_o, const float* __restrict__ ray_d,
            const float* __restrict__ t_max, int R, float t_min, int cap,
            float* __restrict__ out) {
    extern __shared__ float smem[];
    float* s_key = smem;                      // cap
    int* s_id = (int*)(s_key + cap);          // cap
    float* s_cbox = (float*)(s_id + cap);     // 6 x chunks(cap)
    const int cstride = chunks(cap);
    __shared__ float s_red[13][WARPS];
    __shared__ float s_pkt[13];
    __shared__ int s_wcount[WARPS];

    const int tid = threadIdx.x, lane = tid & 31;
    const int first = blockIdx.x * TILE;
    const int k = first + tid;
    const bool active = k < R;
    const int src = active ? k : first;
    const Ray r = tile_ray(ray_o, ray_d, src);
    const float tmax_ray = t_max[src];

    // 1. packet bounds
    packet_bounds(r, tmax_ray, s_red, s_pkt);
    const float tile_tmax = s_pkt[12];
    if (!(tile_tmax > t_min)) {  // no lane can hit: t_min < t < t_max
        if (active) write_row<FULL>(slabs, rows, k, tmax_ray, -1, 0.0f, 0.0f,
                                    out);
        return;
    }

    // 2. packet cull of every cluster, compacted in id order
    const int count = cull_clusters(C, wc_min, wc_max, s_pkt, tile_tmax,
                                    s_key, s_id, s_wcount);

    // 3. bitonic sort of the list, padded to a power of two, by (key, id),
    // unless it is in that order already (a tile whose packet entry is 0
    // for every listed cluster: the incoherent tiles)
    bool in_order = true;
    for (int i = tid; i + 1 < count; i += TILE)
        in_order &= !after(s_key[i], s_id[i], s_key[i + 1], s_id[i + 1]);
    if (!__syncthreads_and(in_order)) {
        int n2 = 1;
        while (n2 < count) n2 <<= 1;
        for (int i = count + tid; i < n2; i += TILE) {
            s_key[i] = INF;
            s_id[i] = 0x7fffffff;
        }
        __syncthreads();
        for (int size = 2; size <= n2; size <<= 1) {
            for (int stride = size >> 1; stride > 0; stride >>= 1) {
                for (int i = tid; i < n2; i += TILE) {
                    int j = i ^ stride;
                    if (j > i) {
                        bool up = (i & size) == 0;
                        float ki = s_key[i], kj = s_key[j];
                        int ii = s_id[i], ij = s_id[j];
                        if (after(ki, ii, kj, ij) == up) {
                            s_key[i] = kj;
                            s_key[j] = ki;
                            s_id[i] = ij;
                            s_id[j] = ii;
                        }
                    }
                }
                __syncthreads();
            }
        }
    }

    // 4. the chunk boxes
    chunk_boxes(count, wc_min, wc_max, s_id, s_cbox, cstride);
    const int n_chunks = chunks(count);
    __syncthreads();  // no thread writes shared memory after this

    // 5. the walk, warp by warp, chunk by chunk. A lane is live while a hit
    // could still improve it (lanes past R and lanes with t_max <= t_min
    // never are); every lane stays in the loop to the warp's end, so each
    // _sync takes the full mask.
    const bool live = active && tmax_ray > t_min;
    float best = tmax_ray;
    int best_tri = -1;
    bool done = false;
    for (int j = 0; j < n_chunks && !done; ++j) {
        if (__all_sync(FULL_MASK, !(live && s_key[CHUNK * j] <= best))) break;
        float ex;
        const float en = slab_enter(
            s_cbox[j], s_cbox[cstride + j], s_cbox[2 * cstride + j],
            s_cbox[3 * cstride + j], s_cbox[4 * cstride + j],
            s_cbox[5 * cstride + j], r, ex);
        unsigned owners = __ballot_sync(
            FULL_MASK, live && en <= ex && en < tmax_ray && en <= best);
        if (owners == 0) continue;
        const int n_entries = min(CHUNK, count - CHUNK * j);
        if (__popc(owners) > n_entries) {
            // more owners than entries (a coherent tile): entry by entry,
            // each owner lane testing its own ray
            const bool owner = (owners >> lane) & 1u;
            for (int e = CHUNK * j; e < CHUNK * j + n_entries; ++e) {
                if (__all_sync(FULL_MASK, !(live && s_key[e] <= best))) {
                    done = true;  // the front-to-back exit, entry by entry
                    break;
                }
                const int c_e = s_id[e];
                float e_en, e_ex;
                ray_box(wc_min, wc_max, c_e, r, e_en, e_ex);
                unsigned tests = __ballot_sync(
                    FULL_MASK, owner && e_en <= e_ex && e_en < tmax_ray &&
                                   e_en <= best);
                while (tests != 0) {  // lowest lane first
                    const int t = __ffs(tests) - 1;
                    tests &= tests - 1;
                    flat_leaf(slabs, rows, c_e, t, r, tmax_ray, t_min, best,
                              best_tri);
                }
            }
            continue;
        }
        // fewer owners than entries: owner by owner, lane l holding entry
        // 32j + l
        const int e = CHUNK * j + lane;
        const bool listed = e < count;
        const int c = listed ? s_id[e] : 0;
        const float* lo = wc_min + 3 * c;
        const float* hi = wc_max + 3 * c;
        const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
        const float hx = __ldg(hi), hy = __ldg(hi + 1), hz = __ldg(hi + 2);
        do {  // owner by owner, lowest lane first
            const int owner = __ffs(owners) - 1;
            owners &= owners - 1;
            Ray q;  // the owner's ray, for the slab test
            q.ox = __shfl_sync(FULL_MASK, r.ox, owner);
            q.oy = __shfl_sync(FULL_MASK, r.oy, owner);
            q.oz = __shfl_sync(FULL_MASK, r.oz, owner);
            q.ix = __shfl_sync(FULL_MASK, r.ix, owner);
            q.iy = __shfl_sync(FULL_MASK, r.iy, owner);
            q.iz = __shfl_sync(FULL_MASK, r.iz, owner);
            const float q_tmax = __shfl_sync(FULL_MASK, tmax_ray, owner);
            float q_ex;
            const float q_en = slab_enter(lx, ly, lz, hx, hy, hz, q, q_ex);
            unsigned pending = __ballot_sync(
                FULL_MASK, listed && q_en <= q_ex && q_en < q_tmax);
            while (pending != 0) {  // the owner's entries in list order
                const int w = __ffs(pending) - 1;
                pending &= pending - 1;
                const float en_w = __shfl_sync(FULL_MASK, q_en, w);
                const int c_w = __shfl_sync(FULL_MASK, c, w);
                if (en_w <= __shfl_sync(FULL_MASK, best, owner))
                    flat_leaf(slabs, rows, c_w, owner, r, tmax_ray, t_min,
                              best, best_tri);
            }
        } while (owners != 0);
    }
    if (!active) return;
    float bu = 0.0f, bv = 0.0f;
    if (best_tri >= 0) {  // u, v of the hit, as its test computed them
        float t;
        moller(slabs + (size_t)(best_tri >> 7) * rows * LANES,
               best_tri & (LANES - 1), r, t_min, tmax_ray, t, bu, bv);
    }
    write_row<FULL>(slabs, rows, k, best, best_tri, bu, bv, out);
}

// K7: the any hit over the same lists, in id order, walked warp by warp
// under the chunk boxes. A lane is live while it can still be occluded:
// it is active, has t_max > t_min and has no hit yet. Every lane stays
// in the loop to the warp's end, so each _sync takes the full mask.
__global__ void __launch_bounds__(TILE, MIN_BLOCKS)
flat_any_kernel(const float* __restrict__ slabs, int rows, int C,
                const float* __restrict__ wc_min,
                const float* __restrict__ wc_max,
                const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ t_max, int R, float t_min, int cap,
                uint8_t* __restrict__ occ) {
    extern __shared__ float smem[];
    float* s_key = smem;                      // cap
    int* s_id = (int*)(s_key + cap);          // cap
    float* s_cbox = (float*)(s_id + cap);     // 6 x chunks(cap)
    const int cstride = chunks(cap);
    __shared__ float s_red[13][WARPS];
    __shared__ float s_pkt[13];
    __shared__ int s_wcount[WARPS];

    const int tid = threadIdx.x, lane = tid & 31;
    const int first = blockIdx.x * TILE;
    const int k = first + tid;
    const bool active = k < R;
    const int src = active ? k : first;
    const Ray r = tile_ray(ray_o, ray_d, src);
    const float tmax_ray = t_max[src];

    packet_bounds(r, tmax_ray, s_red, s_pkt);
    const float tile_tmax = s_pkt[12];
    if (!(tile_tmax > t_min)) {  // no lane can be occluded
        if (active) occ[k] = 0;
        return;
    }
    const int count = cull_clusters(C, wc_min, wc_max, s_pkt, tile_tmax,
                                    s_key, s_id, s_wcount);
    chunk_boxes(count, wc_min, wc_max, s_id, s_cbox, cstride);
    const int n_chunks = chunks(count);
    __syncthreads();  // no thread writes shared memory after this

    const bool can_hit = active && tmax_ray > t_min;
    bool hit = false;
    for (int j = 0; j < n_chunks; ++j) {
        if (__all_sync(FULL_MASK, !can_hit || hit)) break;
        float ex;
        const float en = slab_enter(
            s_cbox[j], s_cbox[cstride + j], s_cbox[2 * cstride + j],
            s_cbox[3 * cstride + j], s_cbox[4 * cstride + j],
            s_cbox[5 * cstride + j], r, ex);
        unsigned owners = __ballot_sync(
            FULL_MASK, can_hit && !hit && en <= ex && en < tmax_ray);
        if (owners == 0) continue;
        const int n_entries = min(CHUNK, count - CHUNK * j);
        if (__popc(owners) > n_entries) {
            // more owners than entries: entry by entry, each owner lane
            // testing its own ray, until every owner is occluded
            const bool owner = (owners >> lane) & 1u;
            for (int e = CHUNK * j; e < CHUNK * j + n_entries; ++e) {
                const bool want = owner && !hit;
                if (__all_sync(FULL_MASK, !want)) break;
                const int c_e = s_id[e];
                float e_en, e_ex;
                ray_box(wc_min, wc_max, c_e, r, e_en, e_ex);
                unsigned tests = __ballot_sync(
                    FULL_MASK, want && e_en <= e_ex && e_en < tmax_ray);
                while (tests != 0) {  // lowest lane first
                    const int t = __ffs(tests) - 1;
                    tests &= tests - 1;
                    if (warp_any(slabs, rows, c_e, owner_ray(r, t), t_min,
                                 __shfl_sync(FULL_MASK, tmax_ray, t)) &&
                        lane == t)
                        hit = true;
                }
            }
            continue;
        }
        // fewer owners than entries: owner by owner, lane l holding entry
        // 32j + l (its box read again for each owner, from L1: registers
        // kept for the cluster tests)
        const int e = CHUNK * j + lane;
        const bool listed = e < count;
        const int c = listed ? s_id[e] : 0;
        do {  // owner by owner, lowest lane first
            const int owner = __ffs(owners) - 1;
            owners &= owners - 1;
            Ray q = owner_ray(r, owner);  // and its reciprocal, for the box
            q.ix = __shfl_sync(FULL_MASK, r.ix, owner);
            q.iy = __shfl_sync(FULL_MASK, r.iy, owner);
            q.iz = __shfl_sync(FULL_MASK, r.iz, owner);
            const float q_tmax = __shfl_sync(FULL_MASK, tmax_ray, owner);
            float q_en, q_ex;
            ray_box(wc_min, wc_max, c, q, q_en, q_ex);
            unsigned pending = __ballot_sync(
                FULL_MASK, listed && q_en <= q_ex && q_en < q_tmax);
            while (pending != 0) {  // the owner's entries in list order
                const int w = __ffs(pending) - 1;
                pending &= pending - 1;
                if (warp_any(slabs, rows, __shfl_sync(FULL_MASK, c, w), q,
                             t_min, q_tmax)) {
                    if (lane == owner) hit = true;
                    break;  // occluded: the owner's other entries go
                }
            }
        } while (owners != 0);
    }
    if (active) occ[k] = hit ? 1 : 0;
}

// Dynamic shared memory of one block, or 0 when it exceeds a block's;
// sets the kernel's limit above 48 KB. The (key, id) list of the next
// power of two above C entries, then the chunk boxes (6 floats a chunk).
template <typename K>
size_t list_smem(K kernel, int C, int& cap, cudaError_t& err) {
    cap = 1;
    while (cap < C) cap <<= 1;
    size_t bytes = sizeof(float) * (2 * (size_t)cap + 6 * (size_t)chunks(cap));
    err = cudaSuccess;
    if (bytes > MAX_SHARED) {
        err = cudaErrorInvalidConfiguration;
        return 0;
    }
    if (bytes > 48 * 1024)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return bytes;
}

template <bool FULL>
int launch(const float* slabs, int rows, int C, const float* wc_min,
           const float* wc_max, const float* ray_o, const float* ray_d,
           const float* t_max, int R, float t_min, float* out,
           cudaStream_t stream) {
    if (R <= 0) return 0;
    int cap;
    cudaError_t e;
    size_t bytes = list_smem(flat_kernel<FULL>, C, cap, e);
    if (e != cudaSuccess) return (int)e;
    flat_kernel<FULL><<<(R + TILE - 1) / TILE, TILE, bytes, stream>>>(
        slabs, rows, C, wc_min, wc_max, ray_o, ray_d, t_max, R, t_min, cap,
        out);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success).

extern "C" int trace_closest_flat(const float* slabs, int rows, int C,
                                  const float* wc_min, const float* wc_max,
                                  const float* ray_o, const float* ray_d,
                                  const float* t_max, int R, float t_min,
                                  float* out, void* stream) {
    return launch<false>(slabs, rows, C, wc_min, wc_max, ray_o, ray_d, t_max,
                         R, t_min, out, (cudaStream_t)stream);
}

extern "C" int trace_closest_flat_full(const float* slabs, int rows, int C,
                                       const float* wc_min,
                                       const float* wc_max,
                                       const float* ray_o, const float* ray_d,
                                       const float* t_max, int R, float t_min,
                                       float* out, void* stream) {
    return launch<true>(slabs, rows, C, wc_min, wc_max, ray_o, ray_d, t_max,
                        R, t_min, out, (cudaStream_t)stream);
}

extern "C" int trace_any_flat(const float* slabs, int rows, int C,
                              const float* wc_min, const float* wc_max,
                              const float* ray_o, const float* ray_d,
                              const float* t_max, int R, float t_min,
                              uint8_t* occ, void* stream) {
    if (R <= 0) return 0;
    int cap;
    cudaError_t e;
    size_t bytes = list_smem(flat_any_kernel, C, cap, e);
    if (e != cudaSuccess) return (int)e;
    flat_any_kernel<<<(R + TILE - 1) / TILE, TILE, bytes,
                      (cudaStream_t)stream>>>(slabs, rows, C, wc_min, wc_max,
                                              ray_o, ray_d, t_max, R, t_min,
                                              cap, occ);
    return (int)cudaGetLastError();
}
