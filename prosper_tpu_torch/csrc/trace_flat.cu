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
// Design: one block of 256 threads per 256 consecutive rays, a tile
// (callers trace 16x16 pixel blocks). The block
// 1. reduces its rays to packet bounds (origin and direction boxes, the
//    largest t_max); a tile with no t_max above t_min writes misses;
// 2. culls all C cluster AABBs against the packet with the interval slab
//    test of ops/intersect.packet_aabb_enter_exit (inverted boxes never
//    overlap) and compacts the survivors, in id order, into a list in
//    shared memory (a ballot and a prefix over warps);
// 3. sorts the list front to back by the packet's entry distance (ties
//    by id; a bitonic sort in shared memory), the order of
//    trace_pallas._cull_lists;
// 4. walks the list: each thread tests its ray's own slab entry into
//    the cluster's AABB, the block skips a cluster no ray enters before
//    its best hit, else stages the cluster's 9x128 Möller rows (4.5 KB)
//    in shared memory and every entering thread tests the 128
//    triangles; the walk stops once the next cluster's packet entry
//    lies beyond every live ray's best hit (the front-to-back exit of
//    trace_pallas.py:165-169);
// 5. the full kernel reads rows 9-37 of the winning triangle once.
//
// The any-hit kernel (K7) runs steps 1, 2 and 4 on the same lists, in id
// order (the order is free for an any hit, so step 3 is left out), with
// the per-ray test "enters the box before t_max", and a lane is done
// once occluded or when its t_max is not above t_min (no hit can occlude
// it). The walk stops when every lane of the block is done
// (_any_kernel :371-373); counting disabled lanes as done keeps a tile
// of lanes that trace nothing from walking its whole list.
//
// The list holds the next power of two above C entries (8 KB of ids and
// 8 KB of keys at C = 2048); the host side refuses a C whose list does
// not fit in the 227 KB of shared memory a block can have, so no
// overlapping cluster is ever dropped.
//
// What bounds them on the H100: the Möller tests (53 float operations
// each, 128 per entered ray-cluster pair) and the block barriers of the
// walk; the slab reads are coalesced and shared by the 256 rays of the
// tile, so the bytes are not the limit. Staging with cp.async or TMA,
// warp-level culls and ray sorting are later work. The Möller test is
// written operation for operation as the plain PyTorch version (built
// with --fmad=false), so hits agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256      // rays per block
#define WARPS (TILE / 32)
#define LANES 128     // triangles per cluster slab
#define SLAB_ROWS 9   // Möller rows staged per cluster
#define DET_EPS 1e-10f
#define BIG 3e38f     // entry / exit of a box no packet overlaps
#define INF __int_as_float(0x7f800000)
#define MAX_SHARED 232448  // dynamic shared memory a block can have

namespace {

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
    return fabsf(d) > 1e-12f ? 1.0f / d : 1e30f;
}

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
    float t0x = (__ldg(a + 0) - r.ox) * r.ix;
    float t1x = (__ldg(b + 0) - r.ox) * r.ix;
    float t0y = (__ldg(a + 1) - r.oy) * r.iy;
    float t1y = (__ldg(b + 1) - r.oy) * r.iy;
    float t0z = (__ldg(a + 2) - r.oz) * r.iz;
    float t1z = (__ldg(b + 2) - r.oz) * r.iz;
    en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
               fmaxf(fminf(t0z, t1z), 0.0f));
    ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

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

// Full hit row (R, 16) at the final hit (csrc/trace_bvh.cu write_full).
__device__ __forceinline__ void write_full(const float* __restrict__ slabs,
                                           int rows, float t, int tri,
                                           float u, float v,
                                           float* __restrict__ o) {
    o[0] = t;
    o[1] = (float)tri;
    if (tri < 0) {
        for (int c = 2; c < 16; ++c) o[c] = 0.0f;
        return;
    }
    const float* s = slabs + (size_t)(tri >> 7) * rows * LANES + (tri & 127);
    float w = 1.0f - u - v;
#define ATTR(r0, r1, r2)                                                  \
    (w * __ldg(s + (r0) * LANES) + u * __ldg(s + (r1) * LANES) +          \
     v * __ldg(s + (r2) * LANES))
    for (int c = 0; c < 3; ++c) o[2 + c] = ATTR(9 + c, 12 + c, 15 + c);
    for (int c = 0; c < 4; ++c) o[5 + c] = ATTR(18 + c, 22 + c, 26 + c);
    for (int c = 0; c < 2; ++c) o[9 + c] = ATTR(30 + c, 32 + c, 34 + c);
#undef ATTR
    o[11] = __ldg(s + 36 * LANES);
    o[12] = __ldg(s + 37 * LANES);
    o[13] = o[14] = o[15] = 0.0f;
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
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    return r;
}

template <bool FULL>
__global__ void __launch_bounds__(TILE)
flat_kernel(const float* __restrict__ slabs, int rows, int C,
            const float* __restrict__ wc_min, const float* __restrict__ wc_max,
            const float* __restrict__ ray_o, const float* __restrict__ ray_d,
            const float* __restrict__ t_max, int R, float t_min, int cap,
            float* __restrict__ out) {
    extern __shared__ float smem[];
    float* s_slab = smem;                      // SLAB_ROWS x LANES
    float* s_key = smem + SLAB_ROWS * LANES;   // cap
    int* s_id = (int*)(s_key + cap);           // cap
    __shared__ float s_red[13][WARPS];
    __shared__ float s_pkt[13];
    __shared__ int s_wcount[WARPS];

    const int tid = threadIdx.x;
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

    // 3. bitonic sort of the list, padded to a power of two, by (key, id)
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

    // 4. the walk
    float best = tmax_ray, bu = 0.0f, bv = 0.0f;
    int best_tri = -1;
    for (int i = 0; i < count; ++i) {
        const float key = s_key[i];
        const int c = s_id[i];
        // a lane is live while a hit could still improve it; the walk
        // ends when the next cluster starts beyond every live lane's best
        // hit (a hit at exactly `best` with a lower id would still win).
        // This barrier also keeps the slab of the last cluster until all
        // threads have tested it.
        const bool live = active && best > t_min;
        if (__syncthreads_and(!(live && key <= best))) break;
        bool need = false;
        if (live) {
            float en, ex;
            ray_box(wc_min, wc_max, c, r, en, ex);
            need = en <= ex && en < tmax_ray && en <= best;
        }
        if (!__syncthreads_or(need)) continue;
        const float* s = slabs + (size_t)c * rows * LANES;
        for (int j = tid; j < SLAB_ROWS * LANES; j += TILE)
            s_slab[j] = __ldg(s + j);
        __syncthreads();
        if (need) {
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                if (moller(s_slab, j, r, t_min, tmax_ray, t, u, v)) {
                    int tri = c * LANES + j;
                    if (t < best || (t == best && tri < best_tri)) {
                        best = t;
                        bu = u;
                        bv = v;
                        best_tri = tri;
                    }
                }
            }
        }
    }
    if (active) write_row<FULL>(slabs, rows, k, best, best_tri, bu, bv, out);
}

// K7: the any hit over the same lists, walked in id order.
__global__ void __launch_bounds__(TILE)
flat_any_kernel(const float* __restrict__ slabs, int rows, int C,
                const float* __restrict__ wc_min,
                const float* __restrict__ wc_max,
                const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ t_max, int R, float t_min, int cap,
                uint8_t* __restrict__ occ) {
    extern __shared__ float smem[];
    float* s_slab = smem;                      // SLAB_ROWS x LANES
    float* s_key = smem + SLAB_ROWS * LANES;   // cap
    int* s_id = (int*)(s_key + cap);           // cap
    __shared__ float s_red[13][WARPS];
    __shared__ float s_pkt[13];
    __shared__ int s_wcount[WARPS];

    const int tid = threadIdx.x;
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

    // the walk: a lane is done once occluded, or from the start when it
    // has no t in (t_min, t_max) or lies past R. The barrier at the top
    // also keeps the last staged slab until all threads have tested it.
    bool done = !(active && tmax_ray > t_min), hit = false;
    for (int i = 0; i < count; ++i) {
        if (__syncthreads_and(done)) break;
        const int c = s_id[i];
        bool need = false;
        if (!done) {
            float en, ex;
            ray_box(wc_min, wc_max, c, r, en, ex);
            need = en <= ex && en < tmax_ray;
        }
        if (!__syncthreads_or(need)) continue;
        const float* s = slabs + (size_t)c * rows * LANES;
        for (int j = tid; j < SLAB_ROWS * LANES; j += TILE)
            s_slab[j] = __ldg(s + j);
        __syncthreads();
        if (need) {
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                if (moller(s_slab, j, r, t_min, tmax_ray, t, u, v)) {
                    hit = done = true;
                    break;
                }
            }
        }
    }
    if (active) occ[k] = hit ? 1 : 0;
}

// Dynamic shared memory of one block (the staged slab and the list), or
// 0 when it exceeds a block's; sets the kernel's limit above 48 KB.
template <typename K>
size_t list_smem(K kernel, int C, int& cap, cudaError_t& err) {
    cap = 1;
    while (cap < C) cap <<= 1;
    size_t bytes = sizeof(float) * (SLAB_ROWS * LANES + 2 * (size_t)cap);
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
