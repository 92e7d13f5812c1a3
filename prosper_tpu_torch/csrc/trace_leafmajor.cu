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
// The per-ray combine (smallest t, then lowest tri; the OR of the
// slots) runs after the kernel, in PyTorch.
//
// Design: one block of 256 threads per pair block. An empty block
// writes misses. Otherwise the leaf's 9 x 128 Möller rows (4.5 KB) are
// staged in shared memory once, and each thread loads its slot's ray by
// index (no gathered (B, 8, 256) columns) and runs the 128 tests from
// shared memory: every thread reads the same triangle at once, one
// broadcast per load. The closest form keeps the running minimum with a
// strict t < best, so the lowest lane wins a tie; the any form stops at
// the first hit. The TPU kernel's two-slot DMA ring, BLOCKS_PER_STEP and
// column layout are not carried.
//
// What bounds it on the H100: the Möller tests, 53 float operations
// each, 128 per valid (ray, leaf) slot; the slab is read once per block
// and the rays are gathered by index (uncoalesced, 28 bytes a slot).
// Cross-block staging with cp.async and keeping several blocks' slabs
// resident are later work. The Möller test is written operation for
// operation as the plain PyTorch version (built with --fmad=false), so
// hits agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256     // ray slots per pair block
#define LANES 128     // triangles per cluster slab
#define SLAB_ROWS 9   // Möller rows staged per leaf
#define DET_EPS 1e-10f
#define NO_HIT 3e38f  // t of a slot without a hit (trace_leafmajor._INF)

namespace {

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

// Möller-Trumbore against triangle j of a staged slab
// (trace_pallas.py:76-116, csrc/trace_bvh.cu moller).
__device__ __forceinline__ bool moller(const float* s, int j, const Ray& r,
                                       float t_min, float t_upper, float& t,
                                       float& u, float& v) {
    float v0x = s[0 * LANES + j], v0y = s[1 * LANES + j];
    float v0z = s[2 * LANES + j], e1x = s[3 * LANES + j];
    float e1y = s[4 * LANES + j], e1z = s[5 * LANES + j];
    float e2x = s[6 * LANES + j], e2y = s[7 * LANES + j];
    float e2z = s[8 * LANES + j];
    float px = r.dy * e2z - r.dz * e2y;
    float py = r.dz * e2x - r.dx * e2z;
    float pz = r.dx * e2y - r.dy * e2x;
    float det = e1x * px + e1y * py + e1z * pz;
    bool ok = fabsf(det) > DET_EPS;
    float inv = ok ? 1.0f / det : 0.0f;
    float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
    u = (tx * px + ty * py + tz * pz) * inv;
    float qx = ty * e1z - tz * e1y;
    float qy = tz * e1x - tx * e1z;
    float qz = tx * e1y - ty * e1x;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
           t < t_upper;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
pairs_kernel(const float* __restrict__ slabs, int rows,
             const int* __restrict__ block_leaf,
             const int* __restrict__ slot_ray,
             const uint8_t* __restrict__ slot_valid,
             const float* __restrict__ ray_o,
             const float* __restrict__ ray_d,
             const float* __restrict__ t_max, float t_min,
             void* __restrict__ out) {
    __shared__ float s_tri[SLAB_ROWS * LANES];
    const int b = blockIdx.x, tid = threadIdx.x;
    const size_t slot = (size_t)b * BLOCK + tid;
    const int leaf = block_leaf[b];  // the same for the whole block
    if (leaf >= 0) {
        const float* s = slabs + (size_t)leaf * rows * LANES;
        for (int i = tid; i < SLAB_ROWS * LANES; i += BLOCK)
            s_tri[i] = __ldg(s + i);
    }
    __syncthreads();
    const bool valid = leaf >= 0 && slot_valid[slot] != 0;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float t_up = 0.0f;
    if (valid) {
        const int k = slot_ray[slot];
        r.ox = ray_o[3 * k];
        r.oy = ray_o[3 * k + 1];
        r.oz = ray_o[3 * k + 2];
        r.dx = ray_d[3 * k];
        r.dy = ray_d[3 * k + 1];
        r.dz = ray_d[3 * k + 2];
        t_up = t_max[k];
    }
    if (ANY) {
        bool hit = false;
        if (valid) {
            for (int j = 0; j < LANES && !hit; ++j) {
                float t, u, v;
                hit = moller(s_tri, j, r, t_min, t_up, t, u, v);
            }
        }
        static_cast<uint8_t*>(out)[slot] = hit ? 1 : 0;
        return;
    }
    float best = t_up, bu = 0.0f, bv = 0.0f;
    int bj = -1;
    if (valid) {
        for (int j = 0; j < LANES; ++j) {
            float t, u, v;
            if (moller(s_tri, j, r, t_min, best, t, u, v)) {
                best = t;
                bu = u;
                bv = v;
                bj = j;
            }
        }
    }
    float* o = static_cast<float*>(out) + (size_t)b * 4 * BLOCK + tid;
    const bool found = bj >= 0;
    o[0] = found ? best : NO_HIT;
    o[BLOCK] = found ? (float)(leaf * LANES + bj) : -1.0f;
    o[2 * BLOCK] = found ? bu : 0.0f;
    o[3 * BLOCK] = found ? bv : 0.0f;
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
    cudaStream_t st = (cudaStream_t)stream;
    if (any_hit)
        pairs_kernel<true><<<B, BLOCK, 0, st>>>(slabs, rows, block_leaf,
                                                slot_ray, slot_valid, ray_o,
                                                ray_d, t_max, t_min, out);
    else
        pairs_kernel<false><<<B, BLOCK, 0, st>>>(slabs, rows, block_leaf,
                                                 slot_ray, slot_valid, ray_o,
                                                 ray_d, t_max, t_min, out);
    return (int)cudaGetLastError();
}
