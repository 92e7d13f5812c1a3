// X1 for Hopper (sm_90a): the per-ray stackless walk of a threaded BVH.
//
//   walk_kernel<true>, walk_kernel<false>  replace
//       experiments/trace_wavefront.py walk_leaves (:158, kernel
//       _walk_kernel :69, pallas_call :167); repack_kernel feeds
//       walk_kernel<false>.
//
// Table (n_chunks, 8, 128) f32 from the port's
// experiments/trace_wavefront.pack_threaded: field f of preorder node n
// at [n >> 7][f][n & 127], fields min.xyz | max.xyz | skip | leaf (-1 for
// an interior node), skip and leaf exact f32 integers. A ray goes to n + 1
// when it enters node n's box (enter <= exit and enter < t_max, the slab
// test of csrc/ray_common.cuh that K2's node_test makes), to skip when it
// misses; n == n_chunks * 128 ends the walk, and the padding nodes' NaN
// bounds are never entered. A ray with t_max <= 0 is dead. Output: each
// ray's entered leaves in walk order, the first l_cap of them, -1 after,
// and the exact count, which keeps counting past l_cap (overflow = count >
// l_cap).
//
// What bounds it on the H100. Every step reads one node and the next node
// depends on this step's test, so a ray's walk is a chain of dependent
// loads with about 25 float32 operations a step; the output (l_cap ints a
// ray) is most of the bytes. The loads bound it: a warp's lanes read
// scattered nodes, and a 16-byte load of 32 distinct nodes takes several
// passes of the SM's shared-memory (and L1) data path. Read from the
// field-major table, a node's 8 fields lie 512 bytes apart: 8 loads to 8
// cache lines a step.
//
// The design. The table is restaged node-major, 32 bytes a node as two
// float4s: lo[n] = min.xyz, max.x and hi[n] = max.yz, skip, leaf (the
// last two as int bits), the lo array then the hi array (16-byte slots,
// so 8 lanes of a quarter-warp reading distinct nodes spread over all 32
// banks). A step is two 16-byte loads and no branch but the rare one that
// records a leaf. walk_kernel<true> copies the table into dynamic shared
// memory (coalesced reads of the field-major rows, one node a thread, its
// two float4s stored whole) and walks it there; it runs persistent
// 1024-thread blocks, as many as fit on the card, each striding over the
// rays, so the table is staged once a block and not once per 128 rays.
// A table larger than a block's shared memory (above 56 chunks on an
// H100) is repacked into device memory by repack_kernel and walked there
// by walk_kernel<false>, the same code reading through the read-only
// cache. Each lane writes its list in 16-byte stores, aligned to the
// output's 16-byte groups: leaves gather in a register int4 and go out
// when its group fills; the -1 padding shares the group the list ends in
// and then fills whole groups; only a group the row shares with its
// neighbour's row, when l_cap is not a multiple of 4, goes out one int at
// a time.

#include <cuda_runtime.h>

#include "ray_common.cuh"

#define BLOCK 1024  // threads a block
#define CHUNK 1024  // floats per 128-node chunk: 8 fields x 128 nodes

namespace {

// Field-major table -> node-major lo | hi, nodes first, first + step,
// ...: a warp reads each field row coalesced and stores 32 neighbouring
// 16-byte slots. skip and leaf are stored as int bits, converted once
// here and not at every step.
__device__ __forceinline__ void repack(const float* __restrict__ table,
                                       int n_nodes, float4* __restrict__ dst,
                                       int first, int step) {
    for (int n = first; n < n_nodes; n += step) {
        const float* f = table + (size_t)(n >> 7) * CHUNK + (n & 127);
        dst[n] = make_float4(__ldg(f), __ldg(f + 128), __ldg(f + 256),
                             __ldg(f + 384));
        dst[n_nodes + n] = make_float4(
            __ldg(f + 512), __ldg(f + 640), __int_as_float((int)__ldg(f + 768)),
            __int_as_float((int)__ldg(f + 896)));
    }
}

__global__ void repack_kernel(const float* __restrict__ table, int n_nodes,
                              float4* __restrict__ nodes) {
    repack(table, n_nodes, nodes, blockIdx.x * blockDim.x + threadIdx.x,
           gridDim.x * blockDim.x);
}

template <bool SHARED>
__device__ __forceinline__ float4 load_node(const float4* p) {
    if constexpr (SHARED)
        return *p;
    else
        return __ldg(p);
}

__device__ __forceinline__ void put(int4& g, int q, int v) {
    g.x = q == 0 ? v : g.x;
    g.y = q == 1 ? v : g.y;
    g.z = q == 2 ? v : g.z;
    g.w = q == 3 ? v : g.w;
}

// The 16-byte group of out starting at index g (a multiple of 4): one
// store when it lies inside the row [b, e), else its ints inside the row.
__device__ __forceinline__ void store_group(int* __restrict__ out, size_t g,
                                            int4 v, size_t b, size_t e) {
    if (g >= b && g + 4 <= e) {
        *reinterpret_cast<int4*>(out + g) = v;
        return;
    }
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (g + q >= b && g + q < e) out[g + q] = w[q];
}

template <bool SHARED>
__global__ void __launch_bounds__(BLOCK, 1)
walk_kernel(const float* __restrict__ table,
            const float4* __restrict__ g_nodes, int n_nodes,
            const float* __restrict__ ray_o, const float* __restrict__ ray_d,
            const float* __restrict__ t_max, int R, int l_cap,
            int* __restrict__ leaves, int* __restrict__ counts) {
    extern __shared__ float4 s_nodes[];
    if constexpr (SHARED) {
        repack(table, n_nodes, s_nodes, threadIdx.x, blockDim.x);
        __syncthreads();
    }
    const float4* lo = SHARED ? s_nodes : g_nodes;
    const float4* hi = lo + n_nodes;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < R;
         k += gridDim.x * blockDim.x) {
        Ray r;
        r.ox = ray_o[3 * k];
        r.oy = ray_o[3 * k + 1];
        r.oz = ray_o[3 * k + 2];
        r.dx = ray_d[3 * k];
        r.dy = ray_d[3 * k + 1];
        r.dz = ray_d[3 * k + 2];
        set_inv(r);
        const float tmax = t_max[k];
        const size_t b = (size_t)k * l_cap, e = b + l_cap;
        int4 grp = make_int4(-1, -1, -1, -1);  // the group holding b + cnt
        int cnt = 0;
        int cur = tmax > 0.0f ? 0 : n_nodes;
        while (cur < n_nodes) {
            const float4 a = load_node<SHARED>(lo + cur);
            const float4 c = load_node<SHARED>(hi + cur);
            float ex;
            const float en = slab_enter(a.x, a.y, a.z, a.w, c.x, c.y, r, ex);
            const bool hit = en <= ex && en < tmax;
            const int leaf = __float_as_int(c.w);
            if (hit && leaf >= 0) {
                if (cnt < l_cap) {
                    const size_t p = b + cnt;
                    put(grp, (int)(p & 3), leaf);
                    if ((p & 3) == 3) store_group(leaves, p - 3, grp, b, e);
                }
                ++cnt;
            }
            cur = hit ? cur + 1 : __float_as_int(c.z);
        }
        size_t p = b + min(cnt, l_cap);
        if (p & 3) {  // the group the list ends in: the rest are -1
            for (int q = (int)(p & 3); q < 4; ++q) put(grp, q, -1);
            store_group(leaves, p & ~(size_t)3, grp, b, e);
            p = (p | 3) + 1;
        }
        const int4 none = make_int4(-1, -1, -1, -1);
        for (; p < e; p += 4) store_group(leaves, p, none, b, e);
        counts[k] = cnt;
    }
}

// Blocks for a persistent launch: as many as fit on the card at once, no
// more than the rays need.
template <typename K>
int persistent_blocks(K kernel, size_t smem, int R, int& blocks) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            BLOCK, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = min(sms * per_sm, (R + BLOCK - 1) / BLOCK);
    return 0;
}

}  // namespace

// C entry point: launches on `stream`, never synchronises, returns the
// first CUDA error (0 on success). nodes null: the table is walked from
// shared memory (walk_kernel<true>); else nodes (2 * n_chunks * 128
// float4s) takes the node-major copy (repack_kernel) and
// walk_kernel<false> walks it there.
extern "C" int walk_leaves(const float* table, int n_chunks,
                           const float* ray_o, const float* ray_d,
                           const float* t_max, int R, int l_cap, int* leaves,
                           int* counts, float* nodes, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int n_nodes = n_chunks * 128;
    if (R <= 0) return (int)cudaGetLastError();
    int blocks = 0, rc;
    if (nodes == nullptr) {
        const size_t smem = (size_t)n_nodes * 2 * sizeof(float4);
        rc = (int)cudaFuncSetAttribute(
            walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (rc == 0) rc = persistent_blocks(walk_kernel<true>, smem, R, blocks);
        if (rc != 0) return rc;
        walk_kernel<true><<<blocks, BLOCK, smem, st>>>(
            table, nullptr, n_nodes, ray_o, ray_d, t_max, R, l_cap, leaves,
            counts);
    } else {
        float4* n4 = reinterpret_cast<float4*>(nodes);
        repack_kernel<<<(n_nodes + 255) / 256, 256, 0, st>>>(table, n_nodes,
                                                             n4);
        rc = persistent_blocks(walk_kernel<false>, 0, R, blocks);
        if (rc != 0) return rc;
        walk_kernel<false><<<blocks, BLOCK, 0, st>>>(
            table, n4, n_nodes, ray_o, ray_d, t_max, R, l_cap, leaves, counts);
    }
    return (int)cudaGetLastError();
}
