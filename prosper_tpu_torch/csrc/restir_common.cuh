// The device functions ReSTIR's kernels share, csrc/restir_initial.cu
// (the initial reservoirs) and csrc/restir_spatial.cu (the spatial
// reuse): native u32 pcg3d and its [0, 1] conversion (mathx/rng.py), the
// clamps and the 3-sum as PyTorch's CUDA operators round them, and
// pHat = luminance(irradiance * BRDF * NoL) of one packed light row
// (render/restir.py _p_hat: render/shading.py sample_light_packed, then
// ops/brdf.py eval_brdf_times_nol). Each is written operation for
// operation as its PyTorch twin; built with --fmad=false, kernels and
// twins round alike.
//
// Rounding: a sum over a last axis of 3 as PyTorch's reduction adds it
// (sum3), a division by a Python constant as a product with its float
// reciprocal, pow(x, 5.0) as powf, clamps that pass NaN on. sqrtf without
// fast math is the function PyTorch's sqrt calls.

#pragma once

#include <cuda_runtime.h>

namespace {

// Python doubles as PyTorch casts them to float32
constexpr float PI_F = 3.141592653589793;
constexpr float INV_2_32 = 2.3283064365386963e-10;  // 2**-32, exact
constexpr float TINY = 1e-20;
constexpr float EPS_K = 1e-4;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.clamp(x, 0, 1) and torch.clamp_min(x, lo): NaN passes through
__device__ __forceinline__ float clamp01(float x) {
    return is_nan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return is_nan(x) ? x : fmaxf(x, lo);
}

// (a * b).sum(-1) over a last axis of 3 as PyTorch's CUDA reduction adds
// it: two threads an output, the first adding elements 0 and 2, then the
// second's element 1 by a shuffle
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
    return (a0 + a2) + a1;
}

__device__ __forceinline__ void pcg3d(unsigned& x, unsigned& y,
                                      unsigned& z) {
    x = x * 1664525u + 1013904223u;
    y = y * 1664525u + 1013904223u;
    z = z * 1664525u + 1013904223u;
    x += y * z;
    y += z * x;
    z += x * y;
    x ^= x >> 16;
    y ^= y >> 16;
    z ^= z >> 16;
    x += y * z;
    y += z * x;
    z += x * y;
}

// mathx/rng.py rng_to01: the exact-rounded conversion times 2**-32
__device__ __forceinline__ float to01(unsigned u) {
    return __uint2float_rn(u) * INV_2_32;
}

struct Surface {
    float px, py, pz, nx, ny, nz, vx, vy, vz, ar, ag, ab, rough, metal, NoV;
};

// eval_brdf_times_nol (ops/brdf.py) for the unit light direction l, then
// luminance(irradiance * brdf * NoL)
__device__ __forceinline__ float brdf_luminance(const Surface& s, float lx,
                                                float ly, float lz, float ir,
                                                float ig, float ib) {
    float hx = lx + s.vx, hy = ly + s.vy, hz = lz + s.vz;
    const float hn = clamp_min(sqrtf(sum3(hx * hx, hy * hy, hz * hz)), TINY);
    hx = hx / hn;
    hy = hy / hn;
    hz = hz / hn;
    const float NoL = clamp01(sum3(s.nx * lx, s.ny * ly, s.nz * lz));
    const float NoH = clamp01(sum3(s.nx * hx, s.ny * hy, s.nz * hz));
    const float VoH = clamp01(sum3(s.vx * hx, s.vy * hy, s.vz * hz));
    const float om = 1.0f - s.metal;
    const float inv_pi = 1.0f / PI_F;  // c_diff / pi on the card
    const float alpha = s.rough * s.rough;
    const float a2 = alpha * alpha;
    const float dd = NoH * NoH * (a2 - 1.0f) + 1.0f;
    const float D = a2 / (PI_F * dd * dd);
    const float fr = powf(1.0f - VoH, 5.0f);
    const float k = clamp_min(alpha * 0.5f, EPS_K);
    const float gl = NoL / (NoL * (1.0f - k) + k);
    const float gv = s.NoV / (s.NoV * (1.0f - k) + k);
    const float spec = D * (gl * gv) / (4.0f * NoL * s.NoV + EPS_K);
    const float f0r = 0.04f * om + s.ar * s.metal;
    const float f0g = 0.04f * om + s.ag * s.metal;
    const float f0b = 0.04f * om + s.ab * s.metal;
    const float br = (s.ar * 0.96f * om * inv_pi
                      + spec * (f0r + (1.0f - f0r) * fr)) * NoL;
    const float bg = (s.ag * 0.96f * om * inv_pi
                      + spec * (f0g + (1.0f - f0g) * fr)) * NoL;
    const float bb = (s.ab * 0.96f * om * inv_pi
                      + spec * (f0b + (1.0f - f0b) * fr)) * NoL;
    return (ir * br) * 0.299f + (ig * bg) * 0.587f + (ib * bb) * 0.114f;
}

// _p_hat: sample_light_packed (render/shading.py) of light li at the
// surface, then the BRDF's luminance
__device__ __forceinline__ float p_hat(const float4* __restrict__ lights,
                                       int li, const Surface& s) {
    const float4 a = __ldg(lights + 3 * li);      // kind, radiance
    const float4 b = __ldg(lights + 3 * li + 1);  // position, radius
    float lx, ly, lz, f;
    if (a.x == 0.0f) {  // the sun: its direction, its radiance
        const float len =
            clamp_min(sqrtf(sum3(b.x * b.x, b.y * b.y, b.z * b.z)), TINY);
        lx = -(b.x / len);
        ly = -(b.y / len);
        lz = -(b.z / len);
        return brdf_luminance(s, lx, ly, lz, a.y, a.z, a.w);
    }
    const float tx = b.x - s.px, ty = b.y - s.py, tz = b.z - s.pz;
    const float d2 = sum3(tx * tx, ty * ty, tz * tz);
    const float d2c = clamp_min(d2, TINY);
    const float dist = sqrtf(d2c);
    lx = tx / dist;
    ly = ty / dist;
    lz = tz / dist;
    if (a.x == 1.0f) {  // point: the radial falloff
        const float dpr = dist / clamp_min(b.w, TINY);
        const float dpr2 = dpr * dpr;
        f = clamp01(1.0f - dpr2 * dpr2) / d2c;
    } else {  // spot: the angular falloff
        const float4 c = __ldg(lights + 3 * li + 2);  // direction, offset
        const float cd = sum3(-c.x * lx, -c.y * ly, -c.z * lz);
        float ang = clamp01(cd * b.w + c.w);
        ang = ang * ang;
        f = ang / d2c;
    }
    return brdf_luminance(s, lx, ly, lz, a.y * f, a.z * f, a.w * f);
}

}  // namespace
