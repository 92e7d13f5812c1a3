// Clustered point + spot shading per 32x32 froxel tile for Hopper
// (sm_90a): the port of the Pallas TPU kernel on the deferred
// renderer's main path.
//
//   shade_clustered_tiles  replaces prosper_tpu/ops/shade_tiles.py
//                          shade_clustered_tiles (:351), kernel
//                          _shade_kernel (:175): per pixel, the Doom
//                          z-slice, the z-slab test of each point light
//                          of the tile's list in ascending order, a
//                          running count of the visible ones of which
//                          the first 128 are shaded, every spot light up
//                          to 128, the BRDF of brdf.glsl:70-88, and zero
//                          where the pixel has no surface.
//   shade_walk_counts      the measurement form (chip_smoke.py alone
//                          calls it): the same walk without the shading,
//                          writing per pixel its shaded point lights,
//                          the list entries its warp walked and the
//                          entries at which some lane of its warp shaded
//                          (the warp's shading union).
//
// Contract (prosper_tpu_torch/ops/shade_tiles.py tile_inputs): chan (13,
// R) f32 planes in row-major pixel order, position3 | normal3 | albedo3
// | roughness | metallic | z_cam | valid; rows (1 + P + S, 12) packed
// light rows [kind, radiance3, position3, radius or angle scale, spot
// direction3, angle offset], sun first; lists (T, lcap) i32 per tile of
// the (ty, tx) grid, counts (T,) i32, lvz (lcap,) f32 the lights'
// view-space z; ints [point_count, spot_eff]; scal [near, far,
// log(far / near), eye.xyz]. out (R, 3) f32.
//
// Design: one froxel tile is shaded by GROUPS blocks of THREADS threads,
// each taking ROWS rows of the tile, one thread per pixel; a warp is 32
// consecutive pixels of one tile row. Each block stages the tile's
// whole list once in dynamic shared memory, with the 8 floats each
// entry needs (position, radiance, radius, view z: 32 bytes an entry,
// 32 KB at 1024 lights, up to MAX_STAGE entries in the 227 KB a block
// may take), so the walk itself has no block barrier; a longer list is
// staged in passes of MAX_STAGE entries. Several 256-thread blocks share
// an SM (MIN_BLOCKS of them at most 80 registers a thread), so one
// block's staging and its uneven tail overlap another's walk. A block
// with no surface among its pixels skips the walk (__syncthreads_or).
// Ragged tiles (1080 = 33 * 32 + 24) mask the threads outside the
// image, which stay for every barrier and vote; a block wholly outside
// the image has no surface.
//
// The warp exit: a pixel's color cannot change after its 128th visible
// light, so before each list entry a warp leaves the point-light walk
// once every lane has counted 128 visible lights or has no surface
// (__all_sync). The walk then costs each warp the list positions up to
// its lanes' last 128th visible light, not the whole list; the colors
// stay those of the walk over the whole list, bit for bit.
//
// What bounds it on the H100: arithmetic. At 1080p with 1024 lights
// whose radius spans the scene every tile lists every light; a pixel
// needs the z-slab tests up to its 128th visible light and 128 point
// evaluations (~100 flops each, among them 2 IEEE square roots and 7
// IEEE divisions); the G-buffer (13 floats a pixel) and the output are
// ~130 MB. A warp runs the shading branch for the union of its lanes'
// visible lights (lanes in different z-slices diverge). Written
// operation for operation like the plain PyTorch version and built with
// --fmad=false (cuda_build.py), so both round alike; rsqrt and fast
// division, as JAX's kernel has them, would change that rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_PX 32
#define ROWS 8                      // tile rows a block shades
#define THREADS (TILE_PX * ROWS)    // one thread per pixel of those rows
#define GROUPS (TILE_PX / ROWS)     // blocks per tile
#define MIN_BLOCKS 3                // blocks an SM must hold: <= 80 registers
#define MAX_SHARED 232448           // dynamic shared memory a block can have
#define ENTRY_BYTES 32              // staged floats of one list entry
#define MAX_STAGE (MAX_SHARED / ENTRY_BYTES)  // list entries per pass
#define MAX_FROXEL_LIGHTS 128
#define Z_SLICES 17
#define FULL_MASK 0xffffffffu
#define PI_F 3.14159265358979323846f
// float(1 / pi) and float(1 / 17): the plain version multiplies by the
// reciprocal where it divides by a constant, as PyTorch's CUDA division
// by a scalar does, and the kernel does the same
#define INV_PI_F 0.318309886183790671537767526745f
#define INV_Z_F 0.0588235294117647058823529411765f

namespace {

struct Pixel {
    float px, py, pz, nx, ny, nz, ivx, ivy, ivz, NoV;
    float f0r, f0g, f0b, cdr, cdg, cdb, a2, k, gv;
};

__device__ __forceinline__ float clamp01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

// brdf * NoL per channel for the unit light direction l
// (shade_tiles.py:241-264).
__device__ __forceinline__ void light_contrib(const Pixel& s, float lx,
                                              float ly, float lz, float& br,
                                              float& bg, float& bb) {
    float hx = lx + s.ivx, hy = ly + s.ivy, hz = lz + s.ivz;
    float hil = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-40f));
    hx = hx * hil;
    hy = hy * hil;
    hz = hz * hil;
    float NoL = clamp01(s.nx * lx + s.ny * ly + s.nz * lz);
    float NoH = clamp01(s.nx * hx + s.ny * hy + s.nz * hz);
    float VoH = clamp01(s.ivx * hx + s.ivy * hy + s.ivz * hz);
    float denom_d = NoH * NoH * (s.a2 - 1.0f) + 1.0f;
    float D = s.a2 / (PI_F * denom_d * denom_d);
    float gl = NoL / (NoL * (1.0f - s.k) + s.k);
    float G = gl * s.gv;
    float x = 1.0f - VoH;
    float x2 = x * x;
    float fr = x2 * x2 * x;
    float spec = D * G / (4.0f * NoL * s.NoV + 1e-4f);
    br = (s.cdr * INV_PI_F + spec * (s.f0r + (1.0f - s.f0r) * fr)) * NoL;
    bg = (s.cdg * INV_PI_F + spec * (s.f0g + (1.0f - s.f0g) * fr)) * NoL;
    bb = (s.cdb * INV_PI_F + spec * (s.f0b + (1.0f - s.f0b) * fr)) * NoL;
}

// The tile walk of K5 (WALK = false) and of its measurement form (WALK =
// true: no shading; per pixel its shaded point lights, its warp's walked
// list entries and the entries at which some lane of its warp shaded).
template <bool WALK>
__device__ __forceinline__ void shade_rows(
    const float* __restrict__ chan, int W, int H, int fx,
    const float* __restrict__ rows, const float* __restrict__ lvz,
    const int* __restrict__ lists, int lcap, const int* __restrict__ counts,
    const int* __restrict__ ints, const float* __restrict__ scal, int stage,
    float* __restrict__ out) {
    // staged list entries: x y z red | view z, radius | green blue
    extern __shared__ float4 s_mem[];
    float4* s_pos = s_mem;
    float2* s_zr = reinterpret_cast<float2*>(s_mem + stage);
    float2* s_gb = s_zr + stage;

    const int t = blockIdx.x / GROUPS;
    const int x = (t % fx) * TILE_PX + (threadIdx.x & (TILE_PX - 1));
    const int y = (t / fx) * TILE_PX + (blockIdx.x % GROUPS) * ROWS +
                  threadIdx.x / TILE_PX;
    const bool inside = x < W && y < H;
    const size_t R = (size_t)W * H;
    const size_t p = inside ? (size_t)y * W + x : 0;
    const bool valid = inside && chan[12 * R + p] > 0.0f;
    if (!__syncthreads_or(valid)) {  // no surface in the block's rows
        if (inside) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = 0.0f;
        return;
    }

    Pixel s;
    s.px = chan[p];
    s.py = chan[R + p];
    s.pz = chan[2 * R + p];
    s.nx = chan[3 * R + p];
    s.ny = chan[4 * R + p];
    s.nz = chan[5 * R + p];
    const float ar = chan[6 * R + p], ag = chan[7 * R + p];
    const float ab = chan[8 * R + p], rough = chan[9 * R + p];
    const float metal = chan[10 * R + p], z_cam = chan[11 * R + p];

    // the pixel's Doom slice (light_clusters.glsl:26-50), clamped before
    // the integer conversion: the same index for every non-NaN z
    const float near = scal[0], lr = scal[2];
    const float ratio = logf(fmaxf(-z_cam / near, 1e-20f)) / lr;
    const float si =
        (float)(int)fminf(fmaxf(Z_SLICES * ratio, 0.0f), Z_SLICES - 1.0f);
    const float near_d = si == 0.0f ? 0.0f : near * expf(si * INV_Z_F * lr);
    const float far_d = near * expf((si + 1.0f) * INV_Z_F * lr);

    // view ray and the BRDF terms that do not depend on the light
    s.ivx = scal[3] - s.px;
    s.ivy = scal[4] - s.py;
    s.ivz = scal[5] - s.pz;
    const float inv_len = 1.0f / sqrtf(fmaxf(
        s.ivx * s.ivx + s.ivy * s.ivy + s.ivz * s.ivz, 1e-40f));
    s.ivx = s.ivx * inv_len;
    s.ivy = s.ivy * inv_len;
    s.ivz = s.ivz * inv_len;
    s.NoV = clamp01(s.nx * s.ivx + s.ny * s.ivy + s.nz * s.ivz);
    s.f0r = 0.04f * (1.0f - metal) + ar * metal;
    s.f0g = 0.04f * (1.0f - metal) + ag * metal;
    s.f0b = 0.04f * (1.0f - metal) + ab * metal;
    s.cdr = ar * 0.96f * (1.0f - metal);
    s.cdg = ag * 0.96f * (1.0f - metal);
    s.cdb = ab * 0.96f * (1.0f - metal);
    const float alpha = rough * rough;
    s.k = fmaxf(alpha * 0.5f, 1e-4f);
    s.a2 = alpha * alpha;
    s.gv = s.NoV / (s.NoV * (1.0f - s.k) + s.k);

    float accr = 0.0f, accg = 0.0f, accb = 0.0f;
    int cnt = 0;            // visible listed lights so far
    bool done = !valid;     // no surface, or 128 visible lights counted
    int walked = 0, uni = 0;  // WALK: the warp's entries walked, shaded
    const int count = counts[t];
    const int* list = lists + (size_t)t * lcap;
    for (int c0 = 0; c0 < count; c0 += stage) {
        const int n = min(stage, count - c0);
        // the previous pass is consumed; a block whose pixels are all
        // done stages no more
        if (c0 > 0 && __syncthreads_and(done)) break;
        for (int e = threadIdx.x; e < n; e += THREADS) {
            const int li = list[c0 + e];
            const float* row = rows + 12 * (size_t)(1 + li);
            s_pos[e] = make_float4(row[4], row[5], row[6], row[1]);
            s_zr[e] = make_float2(lvz[li], row[7]);
            s_gb[e] = make_float2(row[2], row[3]);
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            // the warp exit: no lane's color can change any more
            if (__all_sync(FULL_MASK, done)) break;
            const float2 zr = s_zr[j];
            const float zl = zr.x, rl = zr.y;
            // z-slab test against the pixel's slice
            const bool vis = (-zl - near_d) >= -rl && (zl + far_d) >= -rl;
            const bool shade = vis && !done;
            if (WALK) {
                ++walked;
                uni += __any_sync(FULL_MASK, shade) ? 1 : 0;
            } else if (shade) {
                const float4 pl = s_pos[j];
                const float2 gb = s_gb[j];
                const float tx = pl.x - s.px, ty = pl.y - s.py;
                const float tz = pl.z - s.pz;
                const float d2 = tx * tx + ty * ty + tz * tz;
                const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-20f));
                const float dpr = fmaxf(d2, 1e-20f) * inv_d / fmaxf(rl, 1e-20f);
                const float dpr2 = dpr * dpr;
                const float radial = clamp01(1.0f - dpr2 * dpr2);
                const float w = radial / fmaxf(d2, 1e-20f);
                float br, bg, bb;
                light_contrib(s, tx * inv_d, ty * inv_d, tz * inv_d, br, bg,
                              bb);
                accr = accr + pl.w * w * br;
                accg = accg + gb.x * w * bg;
                accb = accb + gb.y * w * bb;
            }
            cnt += vis ? 1 : 0;
            done = done || cnt >= MAX_FROXEL_LIGHTS;
        }
    }

    if (WALK) {
        if (inside) {
            out[3 * p] = valid ? (float)min(cnt, MAX_FROXEL_LIGHTS) : 0.0f;
            out[3 * p + 1] = (float)walked;
            out[3 * p + 2] = (float)uni;
        }
        return;
    }

    // spot lights: all visible (the reference's isSpotVisible), <= 128
    const int pc = ints[0], spot_eff = ints[1];
    for (int j = 0; j < spot_eff; ++j) {
        const float* row = rows + 12 * (size_t)(1 + pc + j);
        const float tx = __ldg(row + 4) - s.px, ty = __ldg(row + 5) - s.py;
        const float tz = __ldg(row + 6) - s.pz;
        const float d2 = tx * tx + ty * ty + tz * tz;
        const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-20f));
        const float lx = tx * inv_d, ly = ty * inv_d, lz = tz * inv_d;
        const float cd =
            -(__ldg(row + 8) * lx + __ldg(row + 9) * ly + __ldg(row + 10) * lz);
        const float ang = clamp01(cd * __ldg(row + 7) + __ldg(row + 11));
        const float fall = ang * ang / fmaxf(d2, 1e-20f);
        float br, bg, bb;
        light_contrib(s, lx, ly, lz, br, bg, bb);
        accr = accr + __ldg(row + 1) * fall * br;
        accg = accg + __ldg(row + 2) * fall * bg;
        accb = accb + __ldg(row + 3) * fall * bb;
    }

    if (inside) {
        out[3 * p] = valid ? accr : 0.0f;
        out[3 * p + 1] = valid ? accg : 0.0f;
        out[3 * p + 2] = valid ? accb : 0.0f;
    }
}

#define SHADE_ARGS                                                          \
    const float *__restrict__ chan, int W, int H, int fx,                   \
        const float *__restrict__ rows, const float *__restrict__ lvz,      \
        const int *__restrict__ lists, int lcap,                            \
        const int *__restrict__ counts, const int *__restrict__ ints,       \
        const float *__restrict__ scal, int stage, float *__restrict__ out

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
shade_kernel(SHADE_ARGS) {
    shade_rows<false>(chan, W, H, fx, rows, lvz, lists, lcap, counts, ints,
                      scal, stage, out);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
shade_walk_kernel(SHADE_ARGS) {
    shade_rows<true>(chan, W, H, fx, rows, lvz, lists, lcap, counts, ints,
                     scal, stage, out);
}

// Launch one of the two forms over every tile: GROUPS blocks a tile, the
// list staged in passes of at most MAX_STAGE entries.
template <typename Kernel>
int launch(Kernel kernel, const float* chan, int W, int H, const float* rows,
           const float* lvz, const int* lists, int lcap, const int* counts,
           const int* ints, const float* scal, float* out, void* stream) {
    const int fx = (W + TILE_PX - 1) / TILE_PX;
    const int fy = (H + TILE_PX - 1) / TILE_PX;
    if (fx <= 0 || fy <= 0) return 0;
    const int stage = lcap < 1 ? 1 : (lcap < MAX_STAGE ? lcap : MAX_STAGE);
    const size_t bytes = (size_t)stage * ENTRY_BYTES;
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<fx * fy * GROUPS, THREADS, bytes, (cudaStream_t)stream>>>(
        chan, W, H, fx, rows, lvz, lists, lcap, counts, ints, scal, stage,
        out);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success).
extern "C" int shade_clustered_tiles(const float* chan, int W, int H,
                                     const float* rows, const float* lvz,
                                     const int* lists, int lcap,
                                     const int* counts, const int* ints,
                                     const float* scal, float* out,
                                     void* stream) {
    return launch(shade_kernel, chan, W, H, rows, lvz, lists, lcap, counts,
                  ints, scal, out, stream);
}

// The measurement form: out (R, 3) = shaded point lights | entries the
// pixel's warp walked | the warp's shading union.
extern "C" int shade_walk_counts(const float* chan, int W, int H,
                                 const float* rows, const float* lvz,
                                 const int* lists, int lcap,
                                 const int* counts, const int* ints,
                                 const float* scal, float* out,
                                 void* stream) {
    return launch(shade_walk_kernel, chan, W, H, rows, lvz, lists, lcap,
                  counts, ints, scal, out, stream);
}
