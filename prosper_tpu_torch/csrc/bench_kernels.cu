// Measurement kernels for Hopper (sm_90a): the port of the Pallas TPU
// loops of the repo's triangle-test and loop-overhead benchmarks.
//
//   x2_moller_kernel<CHAIN_X2>  replaces experiments/bench_mxu_isect.py
//       run (:130, loop_kernel :94, pallas_call :137), variant "moller";
//   x2_plucker_kernel<false> the same, "plucker" (feature rows made from
//       the 9-row slab in the kernel);
//   x2_plucker_kernel<true>  the same, "plucker_pre" (the 22 rows given);
//   x2_moller_kernel<CHAIN_X3B> (X3b) replaces
//       scripts/bench_visit_breakdown.py moller_loop_kernel (:179, :198);
//   loop_flat_kernel, loop_nested_kernel<4> and <0>, loop_cond_kernel,
//   loop_vec_kernel  replace scripts/bench_loop_overhead.py flat_kernel
//       (:49, :59), nested_kernel (:71, :89), cond_kernel (:98, :114),
//       vec_kernel (:126, :144).
//
// The triangle loops. One block is 256 rays against one 128-triangle
// slab staged in shared memory, `iters` times over, each block's minimum
// t per ray fed into the next through a chain, as the TPU kernels do:
// X2 keeps best = tmin < -1 ? tmin : best (t_upper stays inf), X3b best =
// min(best, tmin + 1e-7), each iteration's t_upper. The chain makes each
// iteration's tests depend on the one before, so none is hoisted out of
// the loop or skipped, though X3b's best stops changing after the first
// iteration: the compiler cannot know it. The Möller
// variants run csrc/ray_common.cuh moller_tri on the FMA units, 53
// float32 operations a test; the Plücker variants do what the TPU did on
// its MXU on the tensor cores: per warp 16-row ray tiles against
// eight-column triangle tiles, four mma.sync m16n8k8 TF32
// products per tile (the sides of edges AB and CA, K = 6 padded to 8,
// and the plane terms n.d and n.o, K = 3 padded to 8), then the epilogue
// of experiments/trace_plucker.py:107-121 in float32 on the fragments.
// The products' operands are rounded to TF32 (cvt.rna), so the Plücker
// loops agree with the Möller loops on hits, not to the bit. The bound:
// FP32 throughput (Möller, and the Plücker epilogue with its
// reciprocal) and TF32 tensor-core throughput (the products), held to one
// SM's share for one block; the loops move almost no bytes.
//
// The design. What bounds a loop is occupancy and latency: with one thread
// running its ray's 128 tests in a row, 8 warps a block, and the IEEE
// division of every test (1 / det, 1 / den) compiled to a range check and a
// branch around a slow-path call, a region the scheduler cannot overlap with
// the next test, most of an SM idles. So: Möller (X2 and X3b, one kernel
// templated on the chain), 1024 threads a block, four neighbouring lanes a
// ray (lane part takes triangles part + 4i, four tests in flight), the slab
// triangle-major in shared memory (two float4 loads and one float a test; a
// load's four triangles lie in distinct banks), a two-step shuffle min at
// the end of an iteration, which X3b's next tests wait for (their t_upper);
// the FP32 issue rate of the SM bounds it, with 32 warps to hide each test's
// latency. Plücker, 512 threads a block, a warp a 16-ray tile against all
// 128 triangles (no warp waits for another after the staging), eight column
// tiles in flight. Both take 1 / x from ray_common.cuh rcp_normal, no
// branch, which gives IEEE division's value for every normal |x| < 2^126 (a
// test's |det| > 1e-10 and |den| > 1e-9 are normal), so the Möller loop
// still equals its plain version bit for bit. Both write the last
// iteration's t from a separate instance of the loop body, so the other
// iterations carry no store. wgmma, which needs 64-row tiles in shared
// memory, is later work.
//
// The loop probes. One thread (flat, nested, cond) adds s[i % 128], read
// from shared memory through a volatile pointer so that every iteration
// that reads s loads, into an unsigned (wrapping) sum; the vector probe is
// one 256-thread block, one element of the (2, 128) pair per thread, with
// a block-wide min per iteration (warp shuffles, then shared memory and
// one __syncthreads, double-buffered). Bound: the dependence chain of one
// iteration times the iteration count.
//
// The flat probe. loop_flat_kernel adds runs of FLAT_RUN values from a
// register double buffer (runs_sum, below) whose loads are issued a run
// ahead at compile-time offsets from the run's window base: one
// volatile 32-bit load and one add into one sum an iteration. Its floor
// is one warp's issue of those shared-memory loads, about 4 cycles a
// load, not the chain's 2 cycles an iteration (PERF.md).
//
// The conditional probe. loop_cond_kernel adds s[i % 128] where i % 4 ==
// 0 and 1 elsewhere, so a quarter of its iterations load; it runs the
// same double buffer with STEP 4 (runs_sum<COND_RUN, 4>): a run's
// COND_RUN / 4 volatile loads issued a run ahead of its adds, one sum.
// The rolled loop it replaced waited out each load's latency on the sum;
// now one warp's issue of the loads, about 5 cycles a load (1.3 cycles an
// iteration), is the floor (PERF.md).
//
// The nested probe asks what it costs to enter an inner loop. Its inner
// trip count is a template parameter, as the Pallas kernel's K is a
// Python constant: loop_nested_kernel<4> runs the script's K = 4 and
// loop_nested_kernel<0> any other k, read at run time. With k read at
// run time nvcc makes each entry a trip-count computation, a peeled
// remainder and a branch tree over bodies unrolled 16, 8 and 4 times,
// which also rereads the shared window's base (S2UR), and the entry's
// adds wait out its loads (about 23 cycles). <KT> loads outer iteration
// i + 1's KT values into a register buffer before it adds iteration i's
// (the inner loop unrolled, as a static trip count allows), and <0>
// keeps a rolled inner loop one trip's load ahead of its add. The only
// loop-carried chain left is the sum's; the outer loop enters the inner
// loop M times, so what the probe takes over the flat loop is the cost
// of those entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define TILE 256  // rays per block
#define LANES 128  // triangles per slab
#define PLU_ROWS 22
#define PLU_DET_EPS 1e-9f
#define TF_STRIDE 136  // tf32 row stride: conflict-free B fragment loads
#define K_STATIC 4  // the nested probe's compile-time inner trip count
#define FLAT_RUN 64  // the flat probe's iterations a run
#define COND_RUN 128  // the conditional probe's iterations a run
#define M_SPLIT 4  // X2 Möller: threads a ray, neighbouring lanes
#define M_THREADS (M_SPLIT * TILE)
#define P_THREADS (32 * TILE / 16)  // X2 Plücker: a warp a 16-ray tile

enum { MOLLER = 0, PLUCKER = 1, PLUCKER_PRE = 2 };
enum { CHAIN_X2 = 0, CHAIN_X3B = 1 };

namespace {

template <int CHAIN>
__device__ __forceinline__ float chain(float best, float tmin) {
    if (CHAIN == CHAIN_X2) return tmin < -1.0f ? tmin : best;
    return fminf(best, tmin + 1e-7f);
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// D = A (16x8, row) * B (8x8, col), TF32 operands, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// Of four values, the one at index i (0..3), without a local array.
__device__ __forceinline__ float pick4(float x0, float x1, float x2, float x3,
                                       int i) {
    return i == 0 ? x0 : i == 1 ? x1 : i == 2 ? x2 : x3;
}

// experiments/trace_plucker.py plucker_rows_from_slab (:42-70) for
// triangle j of the 9-row slab s, into the 22-row block p.
__device__ void plucker_rows(const float* s, int j, float* p) {
    const float v0x = s[0 * LANES + j], v0y = s[1 * LANES + j];
    const float v0z = s[2 * LANES + j], e1x = s[3 * LANES + j];
    const float e1y = s[4 * LANES + j], e1z = s[5 * LANES + j];
    const float e2x = s[6 * LANES + j], e2y = s[7 * LANES + j];
    const float e2z = s[8 * LANES + j];
    const float a0 = v0y * e1z - v0z * e1y, a1 = v0z * e1x - v0x * e1z,
                a2 = v0x * e1y - v0y * e1x;  // v0 x e1
    const float b0 = v0y * e2z - v0z * e2y, b1 = v0z * e2x - v0x * e2z,
                b2 = v0x * e2y - v0y * e2x;  // v0 x e2
    const float n0 = e1y * e2z - e1z * e2y, n1 = e1z * e2x - e1x * e2z,
                n2 = e1x * e2y - e1y * e2x;  // e1 x e2
    const float row[PLU_ROWS] = {
        a0, a1, a2, e1x, e1y, e1z,
        b0 - a0 + n0, b1 - a1 + n1, b2 - a2 + n2,
        e2x - e1x, e2y - e1y, e2z - e1z,
        -b0, -b1, -b2, -e2x, -e2y, -e2z,
        n0, n1, n2,
        n0 * v0x + n1 * v0y + n2 * v0z};
#pragma unroll
    for (int f = 0; f < PLU_ROWS; ++f) p[f * LANES + j] = row[f];
}

// One Möller iteration of one thread: its M_SPLIT-th of the ray's 128
// tests against the triangle-major slab s (triangle j: v0 e1 | e2 x y z
// at float4s 3j, 3j + 1 and float 12j + 8), t_upper = best, four tests
// in flight, 1 / det by rcp_normal; the minimum over the ray's M_SPLIT
// threads (lanes next to each other) goes through CHAIN's rule, so the
// next iteration's tests wait for it. STORE: the last iteration also
// writes each t (inf on a miss) to t_row[j].
template <int CHAIN, bool STORE>
__device__ __forceinline__ float x2_moller_step(const float4* s, int part,
                                                const Ray& r, float t_min,
                                                float best, float* t_row) {
    float tmin = INF;
#pragma unroll 4
    for (int i = 0; i < LANES / M_SPLIT; ++i) {
        const int j = part + M_SPLIT * i;
        const float4 a = s[3 * j], b = s[3 * j + 1];
        const float e2z = reinterpret_cast<const float*>(s)[12 * j + 8];
        float t, u, v;
        const bool hit = moller_tri<true>(a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                                          b.w, e2z, r, t_min, best, t, u, v);
        const float tt = hit ? t : INF;
        tmin = fminf(tmin, tt);
        if (STORE) t_row[j] = tt;
    }
#pragma unroll
    for (int off = 1; off < M_SPLIT; off <<= 1)
        tmin = fminf(tmin, __shfl_xor_sync(FULL_MASK, tmin, off));
    return chain<CHAIN>(best, tmin);
}

// X2 "moller" (CHAIN_X2) and X3b (CHAIN_X3B): 256 rays x 128 triangles
// a block, M_SPLIT threads a ray.
template <int CHAIN>
__global__ void __launch_bounds__(M_THREADS)
x2_moller_kernel(const float* __restrict__ slab,
                 const float* __restrict__ cols, int iters, float t_min,
                 float* __restrict__ best_out, float* __restrict__ t_out) {
    __shared__ float4 s_tri[3 * LANES];
    const int tid = threadIdx.x;
    if (tid < LANES) {
        float* f = reinterpret_cast<float*>(s_tri) + 12 * tid;
#pragma unroll
        for (int q = 0; q < 9; ++q) f[q] = slab[q * LANES + tid];
        f[9] = f[10] = f[11] = 0.0f;
    }
    __syncthreads();
    // ray tid / M_SPLIT of the block's 256, triangles part + M_SPLIT i
    const int ray = tid / M_SPLIT, part = tid % M_SPLIT;
    const size_t k = (size_t)blockIdx.x * TILE + ray;
    const float* c = cols + (size_t)blockIdx.x * 6 * TILE;
    Ray r;
    r.ox = c[ray];
    r.oy = c[TILE + ray];
    r.oz = c[2 * TILE + ray];
    r.dx = c[3 * TILE + ray];
    r.dy = c[4 * TILE + ray];
    r.dz = c[5 * TILE + ray];
    float best = INF;
    const int plain_iters = t_out != nullptr ? iters - 1 : iters;
    for (int it = 0; it < plain_iters; ++it)
        best = x2_moller_step<CHAIN, false>(s_tri, part, r, t_min, best,
                                            nullptr);
    if (t_out != nullptr)
        best = x2_moller_step<CHAIN, true>(s_tri, part, r, t_min, best,
                                           t_out + k * LANES);
    if (part == 0) best_out[k] = best;
}

// The Plücker feature rows of the slab in shared memory, f32 (rows) and
// TF32 (tf: rows 0:6, 12:18, 18:21 at TF_STRIDE): PRE takes the 22 rows
// given, else makes them from the 9-row slab (raw).
template <bool PRE>
__device__ __forceinline__ void plucker_stage(const float* __restrict__ slab,
                                              float* raw, float* rows,
                                              uint32_t* tf) {
    const int tid = threadIdx.x;
    if (PRE) {
        for (int i = tid; i < PLU_ROWS * LANES; i += blockDim.x)
            rows[i] = slab[i];
    } else {
        for (int i = tid; i < 9 * LANES; i += blockDim.x) raw[i] = slab[i];
        __syncthreads();
        if (tid < LANES) plucker_rows(raw, tid, rows);
    }
    __syncthreads();
    for (int i = tid; i < 15 * LANES; i += blockDim.x) {
        const int q = i / LANES, j = i % LANES;
        const int src = q < 6 ? q : q + 6;  // 0:6, then 12:18 and 18:21
        tf[q * TF_STRIDE + j] = tf32(rows[src * LANES + j]);
    }
    __syncthreads();
}

// One X2 Plücker iteration of one warp: its 16 rays against the 128
// triangles, sixteen eight-column tiles, eight in flight, 1 / den by
// rcp_normal; the minimum t of each of the lane's two rays (rows g and g
// + 8), the lane's quad reduced, goes through X2's chain into best.
// STORE: the last iteration also writes each t (inf on a miss) to t_out.
template <bool STORE>
__device__ __forceinline__ void x2_plucker_step(
    const uint32_t* tf, const float* rows, const uint32_t (&a_side)[4],
    const uint32_t (&a_d)[4], const uint32_t (&a_o)[4], float (&best)[2],
    float t_min, float* t_out, size_t ray0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
    float tmin[2] = {INF, INF};
#pragma unroll 8
    for (int nt = 0; nt < LANES / 8; ++nt) {
        const int col = 8 * nt + g;
        const uint32_t b_ab0 = tf[tg * TF_STRIDE + col];
        const uint32_t b_ab1 = tg < 2 ? tf[(tg + 4) * TF_STRIDE + col] : 0u;
        const uint32_t b_ca0 = tf[(6 + tg) * TF_STRIDE + col];
        const uint32_t b_ca1 = tg < 2 ? tf[(10 + tg) * TF_STRIDE + col] : 0u;
        const uint32_t b_n0 = tg < 3 ? tf[(12 + tg) * TF_STRIDE + col] : 0u;
        const int j0 = 8 * nt + 2 * tg;
        const float c0 = rows[21 * LANES + j0];
        const float c1 = rows[21 * LANES + j0 + 1];
        float s1[4], s3[4], den[4], on[4];
        mma_tf32(s1, a_side, b_ab0, b_ab1);
        mma_tf32(s3, a_side, b_ca0, b_ca1);
        mma_tf32(den, a_d, b_n0, 0u);
        mma_tf32(on, a_o, b_n0, 0u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;  // row g or g + 8
            const bool ok = fabsf(den[e]) > PLU_DET_EPS;
            const float inv = ok ? rcp_normal(den[e]) : 0.0f;
            const float t = ((e & 1 ? c1 : c0) - on[e]) * inv;
            const float u = s3[e] * inv;
            const float v = s1[e] * inv;
            const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                             t > t_min && t < best[h];
            const float tt = hit ? t : INF;
            tmin[h] = fminf(tmin[h], tt);
            if (STORE) t_out[(ray0 + 8 * h + g) * LANES + j0 + (e & 1)] = tt;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float m = fminf(tmin[h], __shfl_xor_sync(FULL_MASK, tmin[h], 1));
        m = fminf(m, __shfl_xor_sync(FULL_MASK, m, 2));
        best[h] = chain<CHAIN_X2>(best[h], m);
    }
}

// X2 "plucker" (PRE = false: rows made from the 9-row slab in the kernel)
// and "plucker_pre" (PRE = true: the 22 rows given). Warp w takes rays
// 16w .. 16w + 15 against the whole slab, so no warp waits for another
// after the staging.
template <bool PRE>
__global__ void __launch_bounds__(P_THREADS)
x2_plucker_kernel(const float* __restrict__ slab,
                  const float* __restrict__ cols, int iters, float t_min,
                  float* __restrict__ best_out, float* __restrict__ t_out) {
    __shared__ float s_raw[PRE ? 1 : 9 * LANES];  // the Möller slab
    __shared__ float s_rows[PLU_ROWS * LANES];     // the Plücker rows, f32
    __shared__ uint32_t s_tf[15 * TF_STRIDE];      // rows 0:6, 12:18, 18:21
    plucker_stage<PRE>(slab, s_raw, s_rows, s_tf);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const float* c = cols + (size_t)blockIdx.x * 6 * TILE;
    const size_t ray0 = (size_t)blockIdx.x * TILE + 16 * warp;
    // A fragments of the warp's 16-ray tile: [d | o x d | 0 0], d and o;
    // rows g and g + 8, columns tg and tg + 4
    uint32_t a_side[4], a_d[4], a_o[4];
    float best[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int k = 16 * warp + 8 * h + g;
        const float ox = c[k], oy = c[TILE + k], oz = c[2 * TILE + k];
        const float dx = c[3 * TILE + k], dy = c[4 * TILE + k],
                    dz = c[5 * TILE + k];
        const float mx = oy * dz - oz * dy, my = oz * dx - ox * dz,
                    mz = ox * dy - oy * dx;
        a_side[h] = tf32(pick4(dx, dy, dz, mx, tg));
        a_side[2 + h] = tf32(pick4(my, mz, 0.0f, 0.0f, tg));
        a_d[h] = tf32(pick4(dx, dy, dz, 0.0f, tg));
        a_o[h] = tf32(pick4(ox, oy, oz, 0.0f, tg));
        a_d[2 + h] = a_o[2 + h] = 0u;
        best[h] = INF;
    }
    const int plain_iters = t_out != nullptr ? iters - 1 : iters;
    for (int it = 0; it < plain_iters; ++it)
        x2_plucker_step<false>(s_tf, s_rows, a_side, a_d, a_o, best, t_min,
                               nullptr, ray0);
    if (t_out != nullptr)
        x2_plucker_step<true>(s_tf, s_rows, a_side, a_d, a_o, best, t_min,
                              t_out, ray0);
    if (tg == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) best_out[ray0 + 8 * h + g] = best[h];
    }
}

// The loop probes write their result over an (8, 128) block, as the TPU
// kernels do.
__device__ __forceinline__ void fill_int(int* out, unsigned a) {
    for (int i = 0; i < 8 * 128; ++i) out[i] = (int)a;
}

// m runs of KT iterations of a += s[i % 128] from a register double
// buffer: x holds run e's loaded values and y run e + 1's, and after a
// run's adds the buffer it emptied takes the loads of the run two ahead,
// from the window base (e KT) mod 128 at compile-time offsets (the loop
// takes two runs a trip, so the buffers trade roles without a copy; an
// odd m adds the last run after the loop). STEP = 1 (X3c, X3d): each
// iteration keeps its one volatile 32-bit load and its add into the one
// sum. STEP = 4 (X3e): iteration i loads s[i % 128] when i % 4 == 0 and
// adds 1 otherwise, so a run holds KT / 4 loads, at base + 4q, each with
// its three adds of 1 after it. The loads run a run ahead of the adds.
// Reads past the last run stay inside the window and are never added.
template <int KT, int STEP>
__device__ __forceinline__ void load_run(const volatile int* vs, int e,
                                         int (&buf)[KT / STEP]) {
    static_assert(128 % KT == 0 && KT % STEP == 0, "a run does not wrap s");
    const int base = (e * KT) & 127;
#pragma unroll
    for (int j = 0; j < KT / STEP; ++j) buf[j] = vs[base + STEP * j];
}

template <int KT, int STEP>
__device__ __forceinline__ void add_run(unsigned& a,
                                        const int (&buf)[KT / STEP]) {
#pragma unroll
    for (int j = 0; j < KT / STEP; ++j) {
        a += (unsigned)buf[j];
#pragma unroll
        for (int t = 1; t < STEP; ++t) a += 1u;
    }
}

template <int KT, int STEP = 1>
__device__ __forceinline__ unsigned runs_sum(const volatile int* vs, int m) {
    unsigned a = 0u;
    int x[KT / STEP], y[KT / STEP];
    load_run<KT, STEP>(vs, 0, x);
    load_run<KT, STEP>(vs, 1, y);
    int i = 0;
#pragma unroll 1
    for (; i + 2 <= m; i += 2) {
        add_run<KT, STEP>(a, x);
        load_run<KT, STEP>(vs, i + 2, x);
        add_run<KT, STEP>(a, y);
        load_run<KT, STEP>(vs, i + 3, y);
    }
    if (i < m) add_run<KT, STEP>(a, x);
    return a;
}

// X3c: n iterations, n / FLAT_RUN runs of FLAT_RUN, then the rest one by
// one.
__global__ void loop_flat_kernel(const int* __restrict__ s, int n,
                                 int* __restrict__ out) {
    __shared__ int s_s[128];
    for (int i = 0; i < 128; ++i) s_s[i] = s[i];
    volatile int* vs = s_s;
    const int runs = n / FLAT_RUN;
    unsigned a = runs_sum<FLAT_RUN>(vs, runs);
    for (int i = runs * FLAT_RUN; i < n; ++i) a += (unsigned)vs[i & 127];
    fill_int(out, a);
}

// KT > 0: k == KT trips an entry, each entry a run of runs_sum. KT == 0:
// k trips read at run time, a rolled inner loop whose trip adds the
// value the trip before loaded.
template <int KT>
__global__ void loop_nested_kernel(const int* __restrict__ s, int m, int k,
                                   int* __restrict__ out) {
    __shared__ int s_s[128];
    for (int i = 0; i < 128; ++i) s_s[i] = s[i];
    volatile int* vs = s_s;
    unsigned a = 0u;
    if constexpr (KT > 0) {
        a = runs_sum<KT>(vs, m);
    } else {
        int next = vs[0], j = 0;
#pragma unroll 1
        for (int i = 0; i < m; ++i) {
#pragma unroll 1
            for (int t = 0; t < k; ++t) {
                a += (unsigned)next;
                next = vs[++j & 127];
            }
        }
    }
    fill_int(out, a);
}

// X3e: n iterations, n / COND_RUN runs of COND_RUN (runs_sum's STEP 4),
// then the rest one by one, the condition on the absolute i.
__global__ void loop_cond_kernel(const int* __restrict__ s, int n,
                                 int* __restrict__ out) {
    __shared__ int s_s[128];
    for (int i = 0; i < 128; ++i) s_s[i] = s[i];
    volatile int* vs = s_s;
    const int runs = n / COND_RUN;
    unsigned a = runs_sum<COND_RUN, 4>(vs, runs);
    for (int i = runs * COND_RUN; i < n; ++i)
        a += (i & 3) == 0 ? (unsigned)vs[i & 127] : 1u;
    fill_int(out, a);
}

// v (8, 128): thread e holds element e of rows[0:2], rows[2:4], rows[4:6]
// and rows[6:8]; a += min((rows[0:2] - a) * rows[2:4], (rows[4:6] - a) *
// rows[6:8]) over the block, nv times.
__global__ void __launch_bounds__(TILE)
loop_vec_kernel(const float* __restrict__ v, int nv, float* __restrict__ out) {
    __shared__ float s_min[2][TILE / 32];
    const int e = threadIdx.x;
    const float r0 = v[e], r2 = v[TILE + e], r4 = v[2 * TILE + e],
                r6 = v[3 * TILE + e];
    float a = 0.0f;
    for (int i = 0; i < nv; ++i) {
        float m = fminf((r0 - a) * r2, (r4 - a) * r6);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((e & 31) == 0) s_min[i & 1][e >> 5] = m;
        __syncthreads();
        float b = s_min[i & 1][0];
#pragma unroll
        for (int w = 1; w < TILE / 32; ++w) b = fminf(b, s_min[i & 1][w]);
        a = a + b;
    }
    for (int i = e; i < 8 * 128; i += TILE) out[i] = a;
}

template <typename K>
int launch_isect(K kernel, int threads, const float* slab, const float* cols,
                 int blocks, int iters, float t_min, float* best,
                 float* t_out, cudaStream_t stream) {
    if (blocks > 0)
        kernel<<<blocks, threads, 0, stream>>>(slab, cols, iters, t_min, best,
                                               t_out);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success).

// variant: 0 Möller, 1 Plücker (rows in the kernel), 2 Plücker (rows
// given); chain: 0 X2's, 1 X3b's. t_out may be null.
extern "C" int isect_loop(int variant, int chain_rule, const float* slab,
                          const float* cols, int blocks, int iters,
                          float t_min, float* best, float* t_out,
                          void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (chain_rule == CHAIN_X3B) {
        if (variant != MOLLER) return (int)cudaErrorInvalidValue;
        return launch_isect(x2_moller_kernel<CHAIN_X3B>, M_THREADS, slab,
                            cols, blocks, iters, t_min, best, t_out, st);
    }
    switch (variant) {
        case MOLLER:
            return launch_isect(x2_moller_kernel<CHAIN_X2>, M_THREADS, slab,
                                cols, blocks, iters, t_min, best, t_out, st);
        case PLUCKER:
            return launch_isect(x2_plucker_kernel<false>, P_THREADS, slab,
                                cols, blocks, iters, t_min, best, t_out, st);
        case PLUCKER_PRE:
            return launch_isect(x2_plucker_kernel<true>, P_THREADS, slab,
                                cols, blocks, iters, t_min, best, t_out, st);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int loop_flat(const int* s, int n, int* out, void* stream) {
    loop_flat_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(s, n, out);
    return (int)cudaGetLastError();
}

// kt: the instance, K_STATIC (k must equal it) or 0 (any k).
extern "C" int loop_nested(const int* s, int m, int k, int kt, int* out,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (kt == K_STATIC && k == K_STATIC)
        loop_nested_kernel<K_STATIC><<<1, 1, 0, st>>>(s, m, k, out);
    else if (kt == 0)
        loop_nested_kernel<0><<<1, 1, 0, st>>>(s, m, k, out);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" int loop_cond(const int* s, int n, int* out, void* stream) {
    loop_cond_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(s, n, out);
    return (int)cudaGetLastError();
}

extern "C" int loop_vec(const float* v, int nv, float* out, void* stream) {
    loop_vec_kernel<<<1, TILE, 0, (cudaStream_t)stream>>>(v, nv, out);
    return (int)cudaGetLastError();
}
