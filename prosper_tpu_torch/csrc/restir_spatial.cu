// ReSTIR DI's biased spatial reuse for Hopper (sm_90a), one thread per
// pixel.
//
//   spatial_reuse  replaces no TPU kernel: the JAX package's
//                  spatial_reuse (prosper_tpu/render/restir.py:127) is
//                  jnp inside ops/compact.tile_apply, not a pallas_call.
//                  Its plain PyTorch twin is
//                  prosper_tpu_torch/render/restir.py spatial_reuse_plain,
//                  some 5,000 elementwise and gather operators a frame;
//                  this kernel runs the same per-pixel loop in registers.
//
// Per pixel (spatial_reuse.comp of the reference, as the twin computes
// it): the pcg3d stream seeded with (px, py, frame index); 5 samples,
// each up to 5 tries in a 30 px disk that stop at the first neighbour
// passing the bounds test (a neighbour in pixel row or column 0 is
// rejected, the reference's lessThanEqual(p, 0)), the 10% linear depth
// test and the normal test (dot >= 0.9); the count of samples found,
// empty neighbour reservoirs included; then the streaming resampling of
// the found samples with pHat = luminance(irradiance * BRDF * NoL), the
// RNG advancing on valid samples only, and the UCW with MIS weight
// 1 / that count. The RNG advances on exactly the draws the twin keeps.
//
// Contract (render/restir.py spatial_reuse): surface planes lin_depth
// (R,), normal, position, view, albedo (R, 3), roughness, metallic (R,),
// px, py (R,) int64 absolute pixel coordinates; neigh (rows_h * W, 8)
// the pack_neighbor_rows image of frame rows [neigh_y0, neigh_y0 +
// rows_h): linear depth | oct normal3 | light index | UCW | 0 0; lights
// (1 + P + S, 12) packed light rows [kind, radiance3, position3, radius
// or angle scale, spot direction3, angle offset], sun first; the frame
// index as 32 bits. out_light (R,) int64 (-1: none), out_ucw (R,) f32.
// neigh and lights 16-byte aligned (float4 loads).
//
// What bounds it on the H100: neither bytes nor operations, but the
// latency of each try's dependent chain (RNG, disk offset, neighbour
// load, tests) in an early-exit loop. Its bytes are the pixel's own
// surface, coordinates and neighbour row and the result, about 120 B a
// pixel (0.25 GB at 1080p, 0.074 ms at 3.35 TB/s); its operations about
// 120 a try and 150 a pHat (2.8 G at 1080p at the fewest tries, one a
// sample, 0.042 ms at 67 TFLOP/s; 7.8 G, 0.12 ms, at the most, 25).
//
// Design: 32x8 blocks over the pixels as rows of W, in raster order, so
// the blocks in flight read their 30 px neighbourhoods from one band of
// about 70 rows that stays in L2 (the whole image is 66 MB at 1080p, more
// than L2) and a block's own reads overlap in L1; no shared-memory halo
// (it would take about 140 KB a block and one block an SM). A neighbour
// row is two 16-byte loads; light rows three, through the read-only
// path. The five found samples wait in registers for the resampling
// (the twin draws every try's numbers before the resampling's), so the
// sample loops are unrolled; at most 64 registers a thread
// (__launch_bounds__(256, 4)) keep 4 blocks an SM in flight to hide the
// loads of the early-exit loop.
//
// Rounding: built with --fmad=false (cuda_build.py), every operation in
// the twin's order as PyTorch's CUDA operators round it (pHat, the RNG
// and the clamps are csrc/restir_common.cuh's, which the initial
// reservoirs kernel shares): a sum over a
// last axis of 3 as PyTorch's reduction adds it (sum3), a division by a
// Python constant as a product with its float reciprocal, pow(x, 5.0) as
// powf, clamps that pass NaN on. sqrtf, sinf and cosf without fast math
// are the functions PyTorch's sqrt, sin and cos call.

#include <cuda_runtime.h>

#include "restir_common.cuh"

#define BLOCK_X 32
#define BLOCK_Y 8
#define THREADS (BLOCK_X * BLOCK_Y)
#define MIN_BLOCKS 4  // blocks an SM must hold: <= 64 registers
#define SAMPLES 5
#define TRIES 5

namespace {

// Python doubles as PyTorch casts them to float32
constexpr float RADIUS = 30.0;
constexpr float TWO_PI = 6.283185307179586;  // 2.0 * math.pi
constexpr float DEPTH_TOL = 0.1;
constexpr float NORMAL_MIN = 0.9;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) spatial_reuse_kernel(
    const float* __restrict__ lin_depth, const float* __restrict__ normal,
    const float* __restrict__ position, const float* __restrict__ view,
    const float* __restrict__ albedo, const float* __restrict__ roughness,
    const float* __restrict__ metallic, const long long* __restrict__ px_in,
    const long long* __restrict__ py_in, int R,
    const float4* __restrict__ neigh, const float4* __restrict__ lights,
    int W, int H, int neigh_y0, int rows_h, unsigned frame,
    long long* __restrict__ out_light, float* __restrict__ out_ucw) {
    const int col = blockIdx.x * BLOCK_X + threadIdx.x;
    const long long i =
        (long long)(blockIdx.y * BLOCK_Y + threadIdx.y) * W + col;
    if (col >= W || i >= R) return;

    const int px = (int)px_in[i], py = (int)py_in[i];
    unsigned sx = (unsigned)px, sy = (unsigned)py, sz = frame;
    const float depth = lin_depth[i];
    const float safe_depth = depth != 0.0f ? depth : 1.0f;
    const float nx = normal[3 * i], ny = normal[3 * i + 1],
                nz = normal[3 * i + 2];

    // the rejection loop: up to TRIES tries a sample, the RNG advancing on
    // each try made
    int s_li[SAMPLES];
    float s_ucw[SAMPLES];
    float found_count = 0.0f;
#pragma unroll
    for (int s = 0; s < SAMPLES; ++s) {
        s_li[s] = -1;
        s_ucw[s] = 0.0f;
        bool found = false;
        for (int t = 0; t < TRIES && !found; ++t) {
            pcg3d(sx, sy, sz);
            const float r = sqrtf(to01(sx));
            const float theta = TWO_PI * to01(sy);
            const int qx = px + (int)(r * cosf(theta) * RADIUS * 2.0f - RADIUS);
            const int qy = py + (int)(r * sinf(theta) * RADIUS * 2.0f - RADIUS);
            if (qx <= 0 || qy <= 0 || qx >= W || qy >= H) continue;
            const int row = min(max(qy - neigh_y0, 0), rows_h - 1);
            const long long q = (long long)row * W + qx;
            const float4 a = neigh[2 * q];      // depth, oct normal
            const float4 b = neigh[2 * q + 1];  // light index, UCW
            if (!(fabsf(1.0f - a.x / safe_depth) <= DEPTH_TOL)) continue;
            // signed_oct_decode (mathx/packing.py), then the dot
            const float ex = a.y - a.z;
            const float ey = a.y + a.z - 1.0f;
            const float ez = (a.w * 2.0f - 1.0f) * (1.0f - fabsf(ex) - fabsf(ey));
            const float en = sqrtf(sum3(ex * ex, ey * ey, ez * ez));
            if (!(sum3(ex / en * nx, ey / en * ny, ez / en * nz) >= NORMAL_MIN))
                continue;
            s_li[s] = (int)b.x;
            s_ucw[s] = b.y;
            found = true;
        }
        found_count += found ? 1.0f : 0.0f;
    }

    // the streaming resampling of the valid samples
    Surface sf;
    sf.px = position[3 * i];
    sf.py = position[3 * i + 1];
    sf.pz = position[3 * i + 2];
    sf.nx = nx;
    sf.ny = ny;
    sf.nz = nz;
    sf.vx = view[3 * i];
    sf.vy = view[3 * i + 1];
    sf.vz = view[3 * i + 2];
    sf.ar = albedo[3 * i];
    sf.ag = albedo[3 * i + 1];
    sf.ab = albedo[3 * i + 2];
    sf.rough = roughness[i];
    sf.metal = metallic[i];
    sf.NoV = clamp01(sum3(nx * sf.vx, ny * sf.vy, nz * sf.vz));
    int out_li = -1;
    float out_phat = 0.0f, sum_w = 0.0f;
#pragma unroll
    for (int s = 0; s < SAMPLES; ++s) {
        if (s_li[s] < 0) continue;
        const float phat = p_hat(lights, s_li[s], sf);
        const float w = phat * s_ucw[s];
        sum_w = sum_w + w;
        pcg3d(sx, sy, sz);
        if (to01(sx) < w / (sum_w > 0.0f ? sum_w : 1.0f)) {
            out_li = s_li[s];
            out_phat = phat;
        }
    }
    out_light[i] = out_li;
    out_ucw[i] = out_li >= 0 ? (1.0f / fmaxf(found_count, 1.0f)) * sum_w /
                                   clamp_min(out_phat, TINY)
                             : 0.0f;
}

}  // namespace

// C entry point: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success). frame_index: the frame index's low
// 32 bits.
extern "C" int spatial_reuse(const float* lin_depth, const float* normal,
                             const float* position, const float* view,
                             const float* albedo, const float* roughness,
                             const float* metallic, const long long* px,
                             const long long* py, int R, const float* neigh,
                             const float* lights, int W, int H, int neigh_y0,
                             int rows_h, unsigned frame_index,
                             long long* out_light, float* out_ucw,
                             void* stream) {
    if (R <= 0 || W <= 0) return 0;
    const int rows = (R + W - 1) / W;
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X,
                    (rows + BLOCK_Y - 1) / BLOCK_Y);
    spatial_reuse_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        lin_depth, normal, position, view, albedo, roughness, metallic, px,
        py, R, reinterpret_cast<const float4*>(neigh),
        reinterpret_cast<const float4*>(lights), W, H, neigh_y0, rows_h,
        frame_index, out_light, out_ucw);
    return (int)cudaGetLastError();
}
