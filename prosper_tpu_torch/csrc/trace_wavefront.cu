// X1 for Hopper (sm_90a): the per-ray stackless walk of a threaded BVH.
//
//   walk_kernel  replaces experiments/trace_wavefront.py walk_leaves
//                (:158, kernel _walk_kernel :69, pallas_call :167).
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
// What bounds it on the H100: every step is a dependent read of one
// node's 8 fields (the next node depends on this node's test), scattered
// across the warp's rays, so a ray's walk is a chain of L1/L2 latencies;
// the arithmetic (25 operations a step) is small. plate-2048's table is
// 32 chunks, 128 KB, and stays in L1/L2. This first design is one thread
// per ray reading the table through __ldg. The TPU kernel gathered each
// lane's node with one take_along_axis per chunk, pinned by the slowest
// of 128 lanes; a warp here is pinned by the slowest of its 32. Staging
// the table in shared memory (it fits up to 56 chunks) is later work.

#include <cuda_runtime.h>

#include "ray_common.cuh"

#define BLOCK 128
#define CHUNK 1024  // floats per 128-node chunk: 8 fields x 128 nodes

namespace {

__global__ void walk_kernel(const float* __restrict__ table, int n_nodes,
                            const float* __restrict__ ray_o,
                            const float* __restrict__ ray_d,
                            const float* __restrict__ t_max, int R,
                            int l_cap, int* __restrict__ leaves,
                            int* __restrict__ counts) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= R) return;
    Ray r;
    r.ox = ray_o[3 * k];
    r.oy = ray_o[3 * k + 1];
    r.oz = ray_o[3 * k + 2];
    r.dx = ray_d[3 * k];
    r.dy = ray_d[3 * k + 1];
    r.dz = ray_d[3 * k + 2];
    set_inv(r);
    const float tmax = t_max[k];
    int* out = leaves + (size_t)k * l_cap;
    int cnt = 0;
    int cur = tmax > 0.0f ? 0 : n_nodes;
    while (cur < n_nodes) {
        const float* f = table + (size_t)(cur >> 7) * CHUNK + (cur & 127);
        float ex;
        const float en =
            slab_enter(__ldg(f), __ldg(f + 128), __ldg(f + 256),
                       __ldg(f + 384), __ldg(f + 512), __ldg(f + 640), r, ex);
        const bool hit = en <= ex && en < tmax;
        if (hit) {
            const int leaf = (int)__ldg(f + 896);
            if (leaf >= 0) {
                if (cnt < l_cap) out[cnt] = leaf;
                ++cnt;
            }
            ++cur;
        } else {
            cur = (int)__ldg(f + 768);
        }
    }
    for (int j = cnt; j < l_cap; ++j) out[j] = -1;
    counts[k] = cnt;
}

}  // namespace

// C entry point: launches on `stream`, never synchronises, returns
// cudaGetLastError() (0 on success).
extern "C" int walk_leaves(const float* table, int n_chunks,
                           const float* ray_o, const float* ray_d,
                           const float* t_max, int R, int l_cap, int* leaves,
                           int* counts, void* stream) {
    if (R > 0)
        walk_kernel<<<(R + BLOCK - 1) / BLOCK, BLOCK, 0,
                      (cudaStream_t)stream>>>(table, n_chunks * 128, ray_o,
                                              ray_d, t_max, R, l_cap, leaves,
                                              counts);
    return (int)cudaGetLastError();
}
