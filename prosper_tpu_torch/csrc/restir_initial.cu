// ReSTIR DI's initial reservoirs for Hopper (sm_90a), one thread per
// pixel, written straight into the neighbour rows the spatial reuse
// reads.
//
//   ris_initial  replaces no TPU kernel: the JAX package's
//                initial_reservoirs (prosper_tpu/render/restir.py:67)
//                is jnp, not a pallas_call. Its plain PyTorch twin is
//                prosper_tpu_torch/render/restir.py
//                initial_neighbor_rows_plain (initial_reservoirs, the
//                valid mask and pack_neighbor_rows), some 1,400
//                elementwise, gather and concatenation operators a
//                frame over the int64-emulated RNG; this kernel runs
//                the same per-pixel loop in registers.
//
// Per pixel (initial_reservoirs.comp of the reference, as the twin
// computes it): the pcg3d stream seeded with (px, py, frame index); 5
// uniform light candidates, each drawing u, picking light
// min(int(u * light_count), light_count - 1) (the sun is light 0),
// evaluating pHat = luminance(irradiance * BRDF * NoL), weighting it
// w = (0.2 * pHat) * light_count (MIS 1/M over the pdf 1/light_count),
// adding w to the running sum and keeping the candidate when a second
// draw falls under w / sum; then the UCW sum / pHat of the kept one.
//
// Contract (render/restir.py initial_neighbor_rows): surface planes
// lin_depth (R,), normal, position, view, albedo (R, 3), roughness,
// metallic (R,); normal_metallic (R, 4) the G-buffer's oct normal and
// metallic; valid (R,) bool; px, py (R,) int64 absolute pixel
// coordinates; lights (1 + P + S, 12) packed light rows (as
// restir_common.cuh p_hat reads them), sun first; point_count,
// spot_count the lights' int32 device scalars, read here, so the host
// never waits for them; the frame index as 32 bits. out (R, 8) f32, the
// pack_neighbor_rows row: linear depth | oct normal3 | light index (-1
// where valid is false or nothing was kept) | UCW (not masked by valid,
// as the twin packs it) | 0 0. normal_metallic, lights and out 16-byte
// aligned (float4 loads and stores).
//
// What bounds it on the H100: bytes. About 95 B read a pixel (the
// surface planes, linear depth, normal_metallic, px, py, valid) and 32 B
// written: 0.26 GB at 1080p, 0.08 ms at 3.35 TB/s. Its operations are 5
// pHat evaluations of about 150 and 10 RNG advances of about 20 a pixel:
// about 2 G at 1080p, 0.03 ms at 67 TFLOP/s. The light rows are random
// 48 B loads from a table of at most 2049 rows (98 KB) that stays in L2,
// and in L1 once a block has touched it.
//
// Design: 256-thread blocks over the pixels in their given order (any R,
// any pixel order: px and py come from the input, so a band of a sharded
// frame seeds its absolute rows); the row leaves in two 16-byte stores.
// Rounding: built with --fmad=false (cuda_build.py), every operation in
// the twin's order with its float32 constants (restir_common.cuh).

#include <cuda_runtime.h>

#include "restir_common.cuh"

#define THREADS 256
#define CANDIDATES 5

namespace {

// 1.0 / INITIAL_CANDIDATES, the MIS weight, as PyTorch casts it
constexpr float MIS = 0.2;

__global__ void __launch_bounds__(THREADS) ris_initial_kernel(
    const float* __restrict__ lin_depth,
    const float4* __restrict__ normal_metallic,
    const float* __restrict__ normal, const float* __restrict__ position,
    const float* __restrict__ view, const float* __restrict__ albedo,
    const float* __restrict__ roughness, const float* __restrict__ metallic,
    const bool* __restrict__ valid, const long long* __restrict__ px_in,
    const long long* __restrict__ py_in, int R,
    const float4* __restrict__ lights, const int* __restrict__ point_count,
    const int* __restrict__ spot_count, unsigned frame,
    float4* __restrict__ out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= R) return;

    unsigned sx = (unsigned)px_in[i], sy = (unsigned)py_in[i], sz = frame;
    const float light_count = (float)(1 + __ldg(point_count)
                                      + __ldg(spot_count));
    const int last = (int)(light_count - 1.0f);

    Surface sf;
    sf.px = position[3 * i];
    sf.py = position[3 * i + 1];
    sf.pz = position[3 * i + 2];
    sf.nx = normal[3 * i];
    sf.ny = normal[3 * i + 1];
    sf.nz = normal[3 * i + 2];
    sf.vx = view[3 * i];
    sf.vy = view[3 * i + 1];
    sf.vz = view[3 * i + 2];
    sf.ar = albedo[3 * i];
    sf.ag = albedo[3 * i + 1];
    sf.ab = albedo[3 * i + 2];
    sf.rough = roughness[i];
    sf.metal = metallic[i];
    sf.NoV = clamp01(sum3(sf.nx * sf.vx, sf.ny * sf.vy, sf.nz * sf.vz));

    // streaming RIS over the candidates
    int res_li = -1;
    float res_phat = 0.0f, sum_w = 0.0f;
    for (int c = 0; c < CANDIDATES; ++c) {
        pcg3d(sx, sy, sz);
        const int li = min((int)(to01(sx) * light_count), last);
        const float phat = p_hat(lights, li, sf);
        const float w = MIS * phat * light_count;
        sum_w = sum_w + w;
        pcg3d(sx, sy, sz);
        if (to01(sx) < w / (sum_w > 0.0f ? sum_w : 1.0f)) {
            res_li = li;
            res_phat = phat;
        }
    }
    const float ucw = res_li >= 0 ? sum_w / clamp_min(res_phat, TINY) : 0.0f;

    const float4 nm = normal_metallic[i];
    out[2 * i] = make_float4(lin_depth[i], nm.x, nm.y, nm.z);
    out[2 * i + 1] =
        make_float4(valid[i] ? (float)res_li : -1.0f, ucw, 0.0f, 0.0f);
}

}  // namespace

// C entry point: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success). frame_index: the frame index's low
// 32 bits.
extern "C" int ris_initial(const float* lin_depth,
                           const float* normal_metallic, const float* normal,
                           const float* position, const float* view,
                           const float* albedo, const float* roughness,
                           const float* metallic, const bool* valid,
                           const long long* px, const long long* py, int R,
                           const float* lights, const int* point_count,
                           const int* spot_count, unsigned frame_index,
                           float* out, void* stream) {
    if (R <= 0) return 0;
    const int blocks = (R + THREADS - 1) / THREADS;
    ris_initial_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        lin_depth, reinterpret_cast<const float4*>(normal_metallic), normal,
        position, view, albedo, roughness, metallic, valid, px, py, R,
        reinterpret_cast<const float4*>(lights), point_count, spot_count,
        frame_index, reinterpret_cast<float4*>(out));
    return (int)cudaGetLastError();
}
