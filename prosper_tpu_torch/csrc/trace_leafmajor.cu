// Leaf-major pair-block Möller for Hopper (sm_90a): the port of the
// Pallas TPU kernel of the leaf-major tracer.
//
//   run_pairs  replaces prosper_tpu/ops/trace_leafmajor.py _run_pairs
//              (:397, kernel _pairs_kernel :275): each pair block holds
//              up to 256 rays that want one leaf (cluster); the block's
//              rays are tested against the leaf's 128 triangles.
//
// Contract (prosper_tpu_torch/ops/trace_leafmajor.py run_pairs_plain):
// block_leaf (B,) i32, -1 for an empty block; slot_ray (B, 256) i32 and
// slot_valid (B, 256) u8 name each slot's ray; rays ray_o, ray_d (R, 3)
// f32 and t_max (R,) f32; t_min one float; slabs (C, rows, 128) f32
// with rows 0-8 = v0|e1|e2. A hit is t_min < t < t_max(ray).
//   closest: out (B, 4, 256) f32 rows t | tri | u | v per slot, the
//            slot's nearest hit, lowest lane among equal t
//            (_pairs_kernel :344-352); no hit: t = 3e38, tri = -1,
//            u = v = 0.
//   any:     out (B, 256) u8, 1 where the slot's ray hits the leaf.
// The whole output is written. The per-ray combine (smallest t, then
// lowest tri; the OR of the slots) runs after the kernel, in PyTorch.
//
// What bounds it on the H100. The set is sized statically (B = P / 256
// + C blocks), and on incoherent rays nearly every block is empty: then
// the output's bytes bound it (closest 4 KB a block, any 256 B). On
// sets of mostly live blocks the Möller tests bound it, 53 float
// operations each, 128 per valid slot.
//
// Design: one persistent launch, CTAS_PER_SM 256-thread CTAs an SM, no
// host read. CTA g (of G) first
// 1. tests its live items g + G k. An item is a quarter of a block (64
//    slots); item i is quarter i / B of block i % B, so live blocks at
//    the front of the set (build_blocks' order) are dealt one a CTA, in
//    turn, and any order of live and empty blocks stays correct. An
//    item whose 64 slots are all invalid writes misses and stages
//    nothing; else the leaf's 9 x 128 rows are staged triangle-major in
//    shared memory (two float4 and one float a test) and each slot gets
//    four neighbouring lanes, lane part testing triangles part + 4k (the
//    loop of X2, csrc/bench_kernels.cu), 1 / det by ray_common.cuh
//    rcp_normal (IEEE division's value for every normal |det| < 2^126,
//    no branch). Closest:
//    each lane keeps its nearest hit with a strict t < best, so its
//    lowest triangle among equal t, and the four lanes combine on (t,
//    triangle); lane part writes row part. Any: the warp leaves the loop
//    once every valid slot of it has a hit (a ballot every four tests).
//    The scan for live items reads block_leaf at a stride of G, one
//    load a thread (4 B loads in all, from L2).
// 2. Then it writes the misses of the empty blocks of its contiguous
//    share of the set (B / G blocks, rounded up to a warp): their
//    block_leaf read in coalesced loads, then per empty block 16-byte
//    stores only (closest: a warp writes the block's 4 KB, 8 stores a
//    lane; any: half a warp its 256 B), no barrier between blocks and no
//    slab load. The CTAs without live items start on their misses at
//    once, so the stores fill the memory's bandwidth while the others
//    test.
// The Möller test is written operation for operation as the plain
// PyTorch version (built with --fmad=false), so every slot agrees bit
// for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ray_common.cuh"

#define BLOCK 256         // ray slots per pair block
#define SLAB_ROWS 9       // Möller rows staged per leaf
#define NO_HIT 3e38f      // t of a slot without a hit (trace_leafmajor._INF)
#define THREADS 256       // a CTA
#define CTAS_PER_SM 4
#define SPLIT 4           // lanes a slot, neighbouring
#define ITEM_SLOTS (THREADS / SPLIT)           // 64: a quarter block
#define ITEMS_PER_BLOCK (BLOCK / ITEM_SLOTS)   // 4
#define WARPS (THREADS / 32)
#define SLOT_LEADS 0x11111111u  // lane 4s of a warp: slot s's first lane
// items, chunk offsets and shares stay within int: 4 B + G x 256 < 2^31
#define MAX_BLOCKS (1 << 28)

namespace {

// The miss of row `row` of a closest-hit slot: t | tri | u | v.
__device__ __forceinline__ float miss_row(int row) {
    return row == 0 ? NO_HIT : row == 1 ? -1.0f : 0.0f;
}

// The misses of the empty blocks among the CTA's share of the set: S =
// ceil(B / G) rounded up to a warp, blocks g S to g S + S - 1, their
// block_leaf read in coalesced loads (g = blockIdx.x, G = gridDim.x).
template <bool ANY>
__device__ __forceinline__ void write_empty_blocks(
        const int* __restrict__ block_leaf, int n_blocks, void* out,
        int* s_empty) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int share = ((n_blocks + gridDim.x - 1) / gridDim.x + 31) & ~31;
    const int lo = blockIdx.x * share;
    const int hi = n_blocks - lo < share ? n_blocks : lo + share;
    for (int c0 = lo; c0 < hi; c0 += THREADS) {
        const int n = hi - c0 < THREADS ? hi - c0 : THREADS;
        s_empty[tid] = tid < n && block_leaf[c0 + tid] < 0;
        __syncthreads();
        if (ANY) {
            // half a warp a block: 16 lanes x 16 bytes
            for (int k = 2 * warp + (lane >> 4); k < n; k += 2 * WARPS)
                if (s_empty[k])
                    reinterpret_cast<uint4*>(
                        static_cast<uint8_t*>(out) +
                        (size_t)(c0 + k) * BLOCK)[lane & 15] =
                        make_uint4(0u, 0u, 0u, 0u);
        } else {
            // a warp a block: float4 q = lane + 32 m lies in row q / 64
            for (int k = warp; k < n; k += WARPS) {
                if (!s_empty[k]) continue;
                float4* o = reinterpret_cast<float4*>(out) +
                            (size_t)(c0 + k) * BLOCK;
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const float x = miss_row(m >> 1);
                    o[lane + 32 * m] = make_float4(x, x, x, x);
                }
            }
        }
        __syncthreads();  // s_empty is rewritten
    }
}

// One live item, 64 slots of block b from slot first; every thread of
// the CTA calls it.
template <bool ANY>
__device__ __forceinline__ void run_item(
        const float* __restrict__ slabs, int rows, int leaf, int b,
        int first, const int* __restrict__ slot_ray,
        const uint8_t* __restrict__ slot_valid,
        const float* __restrict__ ray_o, const float* __restrict__ ray_d,
        const float* __restrict__ t_max, float t_min, void* out,
        float4* s_tri) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int slot = first + tid / SPLIT, part = tid % SPLIT;
    const size_t at = (size_t)b * BLOCK + slot;
    const bool valid = slot_valid[at] != 0;
    const int ray = slot_ray[at];  // read with valid: one round trip less
    const bool any_valid = __syncthreads_or(valid);
    if (any_valid && tid < LANES) {
        // triangle tid: v0 e1 | e2 x y z at float4s 3 tid, 3 tid + 1 and
        // float 12 tid + 8
        const float* s = slabs + (size_t)leaf * rows * LANES + tid;
        float* f = reinterpret_cast<float*>(s_tri) + 12 * tid;
#pragma unroll
        for (int q = 0; q < SLAB_ROWS; ++q) f[q] = __ldg(s + q * LANES);
    }
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float t_up = 0.0f;  // an invalid slot: no hit
    if (valid) {
        r.ox = ray_o[3 * ray];
        r.oy = ray_o[3 * ray + 1];
        r.oz = ray_o[3 * ray + 2];
        r.dx = ray_d[3 * ray];
        r.dy = ray_d[3 * ray + 1];
        r.dz = ray_d[3 * ray + 2];
        t_up = t_max[ray];
    }
    __syncthreads();  // the slab is staged
    const float* sf = reinterpret_cast<const float*>(s_tri);
    const bool warp_live = any_valid && __any_sync(FULL_MASK, valid);
    if (ANY) {
        bool hit = false;
        const unsigned need = __ballot_sync(FULL_MASK, valid) & SLOT_LEADS;
        if (warp_live) {
            for (int k0 = 0; k0 < LANES / SPLIT; k0 += 4) {
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const int j = part + SPLIT * (k0 + m);
                    const float4 a = s_tri[3 * j], c = s_tri[3 * j + 1];
                    float t, u, v;
                    hit |= moller_tri<true>(a.x, a.y, a.z, a.w, c.x, c.y, c.z,
                                            c.w, sf[12 * j + 8], r, t_min,
                                            t_up, t, u, v);
                }
                unsigned h = __ballot_sync(FULL_MASK, hit);
                h = (h | h >> 1 | h >> 2 | h >> 3) & SLOT_LEADS;
                if ((need & ~h) == 0) break;
            }
        }
        const unsigned h = __ballot_sync(FULL_MASK, hit) >> (lane & ~3);
        if (part == 0) static_cast<uint8_t*>(out)[at] = (h & 0xfu) ? 1 : 0;
    } else {
        float best = t_up, bu = 0.0f, bv = 0.0f;
        int bj = INT_MAX;  // no hit
        if (warp_live) {
#pragma unroll 4
            for (int k = 0; k < LANES / SPLIT; ++k) {
                const int j = part + SPLIT * k;
                const float4 a = s_tri[3 * j], c = s_tri[3 * j + 1];
                float t, u, v;
                if (moller_tri<true>(a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w,
                                     sf[12 * j + 8], r, t_min, best, t, u,
                                     v)) {
                    best = t;
                    bu = u;
                    bv = v;
                    bj = j;
                }
            }
        }
        // the slot's four lanes: smallest t, then lowest triangle
        float bt = bj != INT_MAX ? best : INF;
#pragma unroll
        for (int off = 1; off < SPLIT; off <<= 1) {
            const float ot = __shfl_xor_sync(FULL_MASK, bt, off);
            const int oj = __shfl_xor_sync(FULL_MASK, bj, off);
            const float ou = __shfl_xor_sync(FULL_MASK, bu, off);
            const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
            if (ot < bt || (ot == bt && oj < bj)) {
                bt = ot;
                bj = oj;
                bu = ou;
                bv = ov;
            }
        }
        const bool found = bj != INT_MAX;
        const float x = !found ? miss_row(part)
                        : part == 0 ? bt
                        : part == 1 ? (float)(leaf * LANES + bj)
                        : part == 2 ? bu : bv;
        static_cast<float*>(out)[(size_t)b * 4 * BLOCK + part * BLOCK + slot] =
            x;
    }
    __syncthreads();  // s_tri is restaged by the next item
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
pair_blocks_kernel(const float* __restrict__ slabs, int rows,
                   const int* __restrict__ block_leaf, int n_blocks,
                   const int* __restrict__ slot_ray,
                   const uint8_t* __restrict__ slot_valid,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d,
                   const float* __restrict__ t_max, float t_min,
                   void* __restrict__ out) {
    __shared__ float4 s_tri[3 * LANES];
    __shared__ int s_list[THREADS];
    __shared__ int s_n;
    const int tid = threadIdx.x, G = gridDim.x, B = n_blocks;
    // the CTA's items g + G k, a chunk of THREADS at a time: its live
    // ones listed in shared memory (as k less the chunk's first), then
    // tested one by one
    const int n_items = ITEMS_PER_BLOCK * B;
    for (int c0 = blockIdx.x; c0 < n_items; c0 += G * THREADS) {
        if (tid == 0) s_n = 0;
        __syncthreads();
        const int i = c0 + tid * G;
        if (i < n_items && block_leaf[i % B] >= 0)
            s_list[atomicAdd(&s_n, 1)] = tid;
        __syncthreads();
        const int n = s_n;
        for (int e = 0; e < n; ++e) {
            const int item = c0 + s_list[e] * G, b = item % B;
            run_item<ANY>(slabs, rows, block_leaf[b], b,
                          item / B * ITEM_SLOTS, slot_ray, slot_valid, ray_o,
                          ray_d, t_max, t_min, out, s_tri);
        }
        __syncthreads();  // s_n and s_list are rewritten
    }
    // then the misses, which fill the memory's bandwidth while other
    // CTAs still test
    write_empty_blocks<ANY>(block_leaf, B, out, s_list);
}

}  // namespace

// C entry point: launches on `stream`, never synchronises, returns
// cudaGetLastError() (0 on success). any_hit selects the output form.
extern "C" int run_pairs(const float* slabs, int rows, const int* block_leaf,
                         int B, const int* slot_ray,
                         const uint8_t* slot_valid, const float* ray_o,
                         const float* ray_d, const float* t_max, float t_min,
                         int any_hit, void* out, void* stream) {
    if (B <= 0) return 0;
    if (B > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int grid = ITEMS_PER_BLOCK * B < sms * CTAS_PER_SM
                         ? ITEMS_PER_BLOCK * B : sms * CTAS_PER_SM;
    cudaStream_t st = (cudaStream_t)stream;
    if (any_hit)
        pair_blocks_kernel<true><<<grid, THREADS, 0, st>>>(
            slabs, rows, block_leaf, B, slot_ray, slot_valid, ray_o, ray_d,
            t_max, t_min, out);
    else
        pair_blocks_kernel<false><<<grid, THREADS, 0, st>>>(
            slabs, rows, block_leaf, B, slot_ray, slot_valid, ray_o, ray_d,
            t_max, t_min, out);
    return (int)cudaGetLastError();
}
