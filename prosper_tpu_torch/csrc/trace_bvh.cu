// BVH ray-trace kernels for Hopper (sm_90a): the port of the six Pallas
// TPU kernels of ops/trace_bvh.py over BVH2 node arrays and of its three
// over 8-wide node tables (trace_closest_bvh8, trace_closest_bvh8_full,
// trace_any_bvh8, at walk8 below).
//
//   trace_primary_bvh_full  replaces prosper_tpu/ops/trace_bvh.py
//                           trace_primary_bvh_full (:1431): in-kernel
//                           pinhole raygen (PT pcg jitter or G-buffer
//                           TAA offset) + closest hit + attribute
//                           interpolation at the final hit.
//   trace_closest_bvh       replaces trace_bvh.py trace_closest_bvh
//                           (:1050): closest hit, (R, 8) rows.
//   trace_closest_bvh_visits  replaces K2's body under DEBUG_VISITS
//                           (scripts/bench_visit_breakdown.py:148): K2's
//                           rows with per-ray node and leaf counts.
//   trace_closest_bvh_full  replaces trace_bvh.py trace_closest_bvh_full
//                           (:1211): closest hit of given rays with an
//                           optional per-cluster skip mask (the culled
//                           G-buffer's draw list) + attributes, (R, 16).
//   trace_any_bvh           replaces trace_bvh.py trace_any_bvh (:1768):
//                           any hit with early exit, (R,) occlusion.
//   trace_any_bvh_dense     replaces trace_bvh.py trace_any_bvh_dense
//                           (:1809): K3's occlusion through a dense cull
//                           of every cluster per 128-ray packet instead of
//                           the stack walk (see dense_any_kernel).
//   trace_closest_bvh_dense replaces trace_bvh.py trace_closest_bvh_dense
//                           (:1144): K2's rows through the same dense
//                           cull (see dense_closest_kernel).
//
// Contract (prosper_tpu_torch/ops/slabs.py): cluster slabs (C, rows, 128)
// f32 with rows 0-8 = v0|e1|e2 and, for the primary kernel, rows 9-37 =
// attributes; BVH2 nodes bounds (N, 6) f32 [min | max] and meta (N, 3)
// i32 [left, right, leaf_cluster (-1 internal)]; one cluster per leaf;
// 8-wide tables as accel/bvh.py pack_nodes8 packs them.
//
// t_min: the Pallas kernels discard their t_min argument and hard-code
// 1e-4 (closest) and 0.1 (any). These kernels honour the argument, as
// the XLA reference tracer (ops/trace.py) does; callers pass the value
// they mean.
//
// The first design (`walk`) is one thread per ray: a per-thread stack of
// STACK_CAP nodes in local memory, near-first ordered descent with
// pruning against the ray's best t, and at each leaf the thread alone
// loops over the cluster's 128 triangles, with the Möller test written
// operation for operation as the plain PyTorch version (compiled with
// --fmad=false) so hits agree bit for bit. What bounds it on the H100 is
// the leaf loop, not the arithmetic (Möller is about an eighth of K2's
// time): each test issues 9 scalar loads of the thread's own cluster, so
// in a warp whose lanes sit in up to 32 different clusters every load
// touches up to 32 cache lines (a leaf round up to 147 KB, served from
// L2), and the warp runs a 128-test round whenever any lane is at a leaf
// while the others idle, so each lane pays at least (the warp's largest
// leaf count) x 128 tests. Only X3a (K2's counting form, the old
// design's yardstick) keeps it.
//
// K1-K4 (`warp_walk`) keep that walk and share the leaf tests: a lane
// walks its own ray's interior nodes until it pops a leaf, which it holds
// pending (K4 drops a leaf of a masked cluster on pop, unread, as `walk`
// did); when every lane holds one or is done, the warp tests the pending
// leaves one owner at a time, all 32 lanes on each, 4 triangles a lane
// and every slab load one full 128-byte line across the warp. A warp's
// tests then scale with the leaves its rays visit, not with 128 times the
// most any lane visits. Each ray's pops, prunes and leaf tests stay
// `walk`'s, so the rows equal its bit for bit. K9-K13 are their own
// kernels. Node layouts, persistent threads, ray reordering and wgmma are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define STACK_CAP 64  // >= BVH depth + 2 (trace_bvh.py:52)
#define LANES 128     // triangles per cluster slab
#define BLOCK 128     // threads per block

namespace {

// Slab test of node i (trace_bvh.py:229-255): kept when enter <= exit
// and enter < best.
__device__ __forceinline__ bool node_test(const float* __restrict__ bounds,
                                          int i, const Ray& r, float best,
                                          float& enter) {
    const float* b = bounds + 6 * i;
    float ex;
    enter = slab_enter(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
                       __ldg(b + 4), __ldg(b + 5), r, ex);
    return enter <= ex && enter < best;
}

// Möller-Trumbore against triangle j of a slab (trace_pallas.py:76-116).
__device__ __forceinline__ bool moller(const float* __restrict__ s, int j,
                                       const Ray& r, float t_min,
                                       float t_upper, float& t, float& u,
                                       float& v) {
    return moller_tri(__ldg(s + 0 * LANES + j), __ldg(s + 1 * LANES + j),
                      __ldg(s + 2 * LANES + j), __ldg(s + 3 * LANES + j),
                      __ldg(s + 4 * LANES + j), __ldg(s + 5 * LANES + j),
                      __ldg(s + 6 * LANES + j), __ldg(s + 7 * LANES + j),
                      __ldg(s + 8 * LANES + j), r, t_min, t_upper, t, u, v);
}

struct Hit {
    float t, u, v;
    int tri;
};

// Near-first ordered BVH2 walk, one thread per ray, closest hit, for
// X3a: counts into n[0] the interior nodes it expands (pops that pass the
// prune) and into n[1] the leaves it tests. Returns false on stack
// overflow.
__device__ bool walk(const float* __restrict__ slabs, int rows,
                     const float* __restrict__ bounds,
                     const int* __restrict__ meta, const Ray& r, float t_min,
                     Hit& h, int* n) {
    int stack_node[STACK_CAP];
    float stack_enter[STACK_CAP];
    int sp = 0;
    float en;
    if (node_test(bounds, 0, r, h.t, en)) {
        stack_node[0] = 0;
        stack_enter[0] = en;
        sp = 1;
    }
    while (sp > 0) {
        --sp;
        int i = stack_node[sp];
        if (stack_enter[sp] >= h.t) continue;  // pruned by a closer hit
        int leaf = __ldg(meta + 3 * i + 2);
        if (leaf >= 0) {
            ++n[1];
            const float* s = slabs + (size_t)leaf * rows * LANES;
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                // strict t < h.t: within a cluster the lowest lane wins
                // a tie, across clusters the earlier visit keeps it
                if (moller(s, j, r, t_min, h.t, t, u, v)) {
                    h.t = t;
                    h.u = u;
                    h.v = v;
                    h.tri = leaf * LANES + j;
                }
            }
            continue;
        }
        ++n[0];
        int l = __ldg(meta + 3 * i), rc = __ldg(meta + 3 * i + 1);
        float el, er;
        bool hl = node_test(bounds, l, r, h.t, el);
        bool hr = node_test(bounds, rc, r, h.t, er);
        if (sp + (int)hl + (int)hr > STACK_CAP) return false;
        bool left_near = el <= er;
        // push the far child first so the near one pops next
        if (hl && hr) {
            stack_node[sp] = left_near ? rc : l;
            stack_enter[sp] = left_near ? er : el;
            ++sp;
            stack_node[sp] = left_near ? l : rc;
            stack_enter[sp] = left_near ? el : er;
            ++sp;
        } else if (hl || hr) {
            stack_node[sp] = hl ? l : rc;
            stack_enter[sp] = hl ? el : er;
            ++sp;
        }
    }
    return true;
}

// Full hit row (R, 16): t | tri | attributes once, at the final hit
// (slabs.attrs_from_hit_rows): a(row) = w*row[v0] + u*row[v1] +
// v*row[v2], w = 1 - u - v; zero attributes on a miss.
__device__ __forceinline__ void write_full(const float* __restrict__ slabs,
                                           int rows, const Hit& h,
                                           float* __restrict__ o) {
    o[0] = h.t;
    o[1] = (float)h.tri;
    if (h.tri < 0) {
        for (int c = 2; c < 16; ++c) o[c] = 0.0f;
        return;
    }
    const float* s = slabs + (size_t)(h.tri >> 7) * rows * LANES + (h.tri & 127);
    float w = 1.0f - h.u - h.v;
#define ATTR(r0, r1, r2)                                                  \
    (w * __ldg(s + (r0) * LANES) + h.u * __ldg(s + (r1) * LANES) +        \
     h.v * __ldg(s + (r2) * LANES))
    for (int c = 0; c < 3; ++c) o[2 + c] = ATTR(9 + c, 12 + c, 15 + c);
    for (int c = 0; c < 4; ++c) o[5 + c] = ATTR(18 + c, 22 + c, 26 + c);
    for (int c = 0; c < 2; ++c) o[9 + c] = ATTR(30 + c, 32 + c, 34 + c);
#undef ATTR
    o[11] = __ldg(s + 36 * LANES);
    o[12] = __ldg(s + 37 * LANES);
    o[13] = o[14] = o[15] = 0.0f;
}

__device__ __forceinline__ void load_ray(const float* __restrict__ ray_o,
                                         const float* __restrict__ ray_d,
                                         int k, Ray& r) {
    r.ox = ray_o[3 * k];
    r.oy = ray_o[3 * k + 1];
    r.oz = ray_o[3 * k + 2];
    r.dx = ray_d[3 * k];
    r.dy = ray_d[3 * k + 1];
    r.dz = ray_d[3 * k + 2];
    set_inv(r);
}

// X3a, K2 with DEBUG_VISITS (scripts/bench_visit_breakdown.py:148,
// trace_bvh.py:941), on `walk`: K2's (R, 8) rows t | tri | u | v | pad,
// with the interior nodes the ray expands in pad row 6 and the leaves it
// tests in pad row 7 (JAX writes each packet's leaf visits into row 7).
// Rows 0-5 equal K2's.
__global__ void closest_kernel(const float* __restrict__ slabs, int rows,
                               const float* __restrict__ bounds,
                               const int* __restrict__ meta,
                               const float* __restrict__ ray_o,
                               const float* __restrict__ ray_d,
                               const float* __restrict__ t_max, int R,
                               float t_min, float* __restrict__ out,
                               int* __restrict__ err) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= R) return;
    Ray r;
    load_ray(ray_o, ray_d, k, r);
    Hit h = {t_max[k], 0.0f, 0.0f, -1};
    int n[2] = {0, 0};
    if (h.t > 0.0f && !walk(slabs, rows, bounds, meta, r, t_min, h, n))
        atomicExch(err, 1);
    float* o = out + 8 * (size_t)k;
    o[0] = h.t;
    o[1] = (float)h.tri;
    o[2] = h.u;
    o[3] = h.v;
    o[4] = o[5] = 0.0f;
    o[6] = (float)n[0];
    o[7] = (float)n[1];
}

#define FULL_MASK 0xffffffffu
#define NO_KEY 0xffffffffu  // a lane without a hit in the leaf

// `walk`'s loop up to its next leaf: pops, prunes against best, tests
// and pushes an interior node's children as `walk` does, until it pops a
// leaf, whose cluster it returns, or its stack is empty (-1). LIVE: a
// popped leaf whose cluster has live[cluster] == 0 is dropped there,
// unread (live == nullptr: every cluster is live). On stack overflow sets
// ok = false and empties the stack.
template <bool LIVE>
__device__ __forceinline__ int next_leaf(const float* __restrict__ bounds,
                                         const int* __restrict__ meta,
                                         const uint8_t* __restrict__ live,
                                         const Ray& r, float best,
                                         int* stack_node, float* stack_enter,
                                         int& sp, bool& ok) {
    while (sp > 0) {
        --sp;
        const int i = stack_node[sp];
        if (stack_enter[sp] >= best) continue;  // pruned by a closer hit
        const int leaf = __ldg(meta + 3 * i + 2);
        if (leaf >= 0) {
            if (LIVE && live != nullptr && __ldg(live + leaf) == 0) continue;
            return leaf;
        }
        const int l = __ldg(meta + 3 * i), rc = __ldg(meta + 3 * i + 1);
        float el, er;
        const bool hl = node_test(bounds, l, r, best, el);
        const bool hr = node_test(bounds, rc, r, best, er);
        if (sp + (int)hl + (int)hr > STACK_CAP) {
            ok = false;
            sp = 0;
            return -1;
        }
        const bool left_near = el <= er;
        // push the far child first so the near one pops next
        if (hl && hr) {
            stack_node[sp] = left_near ? rc : l;
            stack_enter[sp] = left_near ? er : el;
            ++sp;
            stack_node[sp] = left_near ? l : rc;
            stack_enter[sp] = left_near ? el : er;
            ++sp;
        } else if (hl || hr) {
            stack_node[sp] = hl ? l : rc;
            stack_enter[sp] = hl ? el : er;
            ++sp;
        }
    }
    return -1;
}

// A hit's t as an unsigned key of the same order; -0 and +0, equal as
// floats, give one key. A hit's t is finite, so its key is below NO_KEY.
__device__ __forceinline__ unsigned t_key(float t) {
    const unsigned b = __float_as_uint(t == 0.0f ? 0.0f : t);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// K1-K4's walk: `walk` per lane, the leaf tests by the whole warp. Every
// thread of the warp calls it, a lane without a ray with h.t = 0 (it
// never enters the root), and stays to the end: each _sync takes the
// full mask. ANY=true: the owner of a leaf with any hit is done, and
// h.tri >= 0 marks it occluded (K3). LIVE: the skip mask `live` (K4).
// Sets *err on stack overflow.
//
// A leaf owned by lane src with best t b: lane l tests triangles l + 32q
// (q = 0..3) against the owner's ray with t_upper = b and keeps its
// lowest t, the lowest j among equal t; the warp takes the minimum key
// of t, then the lowest j among the lanes at that key. `walk`'s loop
// over j = 0..127 with a strict t < best keeps the same triangle: the
// lowest t below b and, among equal t, the lowest j. Every hit lies below
// b, so the owner always takes it, and a later cluster's equal t never
// replaces it: the earlier visit keeps a tie across clusters.
template <bool ANY, bool LIVE>
__device__ void warp_walk(const float* __restrict__ slabs, int rows,
                          const float* __restrict__ bounds,
                          const int* __restrict__ meta, const Ray& r,
                          float t_min, const uint8_t* __restrict__ live,
                          Hit& h, int* __restrict__ err) {
    const int lane = threadIdx.x & 31;
    int stack_node[STACK_CAP];
    float stack_enter[STACK_CAP];
    int sp = 0;
    float en;
    if (h.t > 0.0f && node_test(bounds, 0, r, h.t, en)) {
        stack_node[0] = 0;
        stack_enter[0] = en;
        sp = 1;
    }
    bool ok = true;
    for (;;) {
        // each lane walks until it holds a leaf or is done
        const int leaf = next_leaf<LIVE>(bounds, meta, live, r, h.t,
                                         stack_node, stack_enter, sp, ok);
        unsigned pending = __ballot_sync(FULL_MASK, leaf >= 0);
        if (pending == 0) break;
        do {  // the pending leaves, lowest owner lane first
            const int src = __ffs(pending) - 1;
            pending &= pending - 1;
            Ray q;  // the owner's ray; Möller reads no reciprocal
            q.ox = __shfl_sync(FULL_MASK, r.ox, src);
            q.oy = __shfl_sync(FULL_MASK, r.oy, src);
            q.oz = __shfl_sync(FULL_MASK, r.oz, src);
            q.dx = __shfl_sync(FULL_MASK, r.dx, src);
            q.dy = __shfl_sync(FULL_MASK, r.dy, src);
            q.dz = __shfl_sync(FULL_MASK, r.dz, src);
            q.ix = q.iy = q.iz = 0.0f;
            const float best = __shfl_sync(FULL_MASK, h.t, src);
            const int c = __shfl_sync(FULL_MASK, leaf, src);
            const float* s = slabs + (size_t)c * rows * LANES + lane;
            if (ANY) {
                bool hit = false;
#pragma unroll
                for (int j = 0; j < LANES; j += 32) {
                    float t, u, v;
                    hit |= moller(s, j, q, t_min, best, t, u, v);
                }
                if (__any_sync(FULL_MASK, hit) && lane == src) {
                    h.tri = c * LANES;  // occluded: the owner is done
                    sp = 0;
                }
            } else {
                float bt = best, bu = 0.0f, bv = 0.0f;
                int bj = -1;
#pragma unroll
                for (int j = 0; j < LANES; j += 32) {
                    float t, u, v;
                    if (moller(s, j, q, t_min, best, t, u, v) && t < bt) {
                        bt = t;
                        bu = u;
                        bv = v;
                        bj = lane + j;
                    }
                }
                const unsigned key = bj >= 0 ? t_key(bt) : NO_KEY;
                const unsigned kmin = __reduce_min_sync(FULL_MASK, key);
                if (kmin != NO_KEY) {
                    const unsigned j = __reduce_min_sync(
                        FULL_MASK, key == kmin ? (unsigned)bj : NO_KEY);
                    const int w = (int)(j & 31u);
                    const float t = __shfl_sync(FULL_MASK, bt, w);
                    const float u = __shfl_sync(FULL_MASK, bu, w);
                    const float v = __shfl_sync(FULL_MASK, bv, w);
                    if (lane == src) {
                        h.t = t;
                        h.u = u;
                        h.v = v;
                        h.tri = c * LANES + (int)j;
                    }
                }
            }
        } while (pending != 0);
    }
    if (!ok) atomicExch(err, 1);
}

// The ray of lane k, or for k >= R none (h.t = 0: it never walks).
__device__ __forceinline__ void load_lane(const float* __restrict__ ray_o,
                                          const float* __restrict__ ray_d,
                                          const float* __restrict__ t_max,
                                          int R, int k, Ray& r, Hit& h) {
    r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    h = {0.0f, 0.0f, 0.0f, -1};
    if (k < R) {
        load_ray(ray_o, ray_d, k, r);
        h.t = t_max[k];
    }
}

// K2: (R, 8) rows t | tri | u | v | pad; a miss has t = t_max, tri = -1.
__global__ void warp_closest_kernel(const float* __restrict__ slabs,
                                    int rows,
                                    const float* __restrict__ bounds,
                                    const int* __restrict__ meta,
                                    const float* __restrict__ ray_o,
                                    const float* __restrict__ ray_d,
                                    const float* __restrict__ t_max, int R,
                                    float t_min, float* __restrict__ out,
                                    int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk<false, false>(slabs, rows, bounds, meta, r, t_min, nullptr, h,
                            err);
    if (k >= R) return;
    float* o = out + 8 * (size_t)k;
    o[0] = h.t;
    o[1] = (float)h.tri;
    o[2] = h.u;
    o[3] = h.v;
    o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// K3: (R,) occlusion, a hit being t_min < t < t_max.
__global__ void warp_any_kernel(const float* __restrict__ slabs, int rows,
                                const float* __restrict__ bounds,
                                const int* __restrict__ meta,
                                const float* __restrict__ ray_o,
                                const float* __restrict__ ray_d,
                                const float* __restrict__ t_max, int R,
                                float t_min, uint8_t* __restrict__ occ,
                                int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk<true, false>(slabs, rows, bounds, meta, r, t_min, nullptr, h,
                           err);
    if (k < R) occ[k] = h.tri >= 0 ? 1 : 0;
}

// K4: the warp walk with the cluster skip mask (live == nullptr: none),
// and the attributes of write_full at the final hit.
__global__ void closest_full_kernel(const float* __restrict__ slabs, int rows,
                                    const float* __restrict__ bounds,
                                    const int* __restrict__ meta,
                                    const float* __restrict__ ray_o,
                                    const float* __restrict__ ray_d,
                                    const float* __restrict__ t_max, int R,
                                    float t_min,
                                    const uint8_t* __restrict__ live,
                                    float* __restrict__ out,
                                    int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk<false, true>(slabs, rows, bounds, meta, r, t_min, live, h,
                           err);
    if (k < R) write_full(slabs, rows, h, out + 16 * (size_t)k);
}

// One pcg3d round of uvec3(x, y, z) (random.glsl:17-28).
__device__ __forceinline__ void pcg3d(uint32_t& x, uint32_t& y, uint32_t& z) {
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

// cam (24 f32, trace_bvh.primary_cam_vec): eye(0:3) | A(3:6) | B(6:9) |
// C(9:12) | W H (12:14) | offx offy pcg_on (14:17); d = normalize(ux*A
// + uy*B + C), ux = (px + pcg_on*jx + offx) / W (_raygen_tile,
// trace_bvh.py:212-214): pcg_on = 1, off = 0 is the path tracer's
// per-pixel jitter, pcg_on = 0 the G-buffer's TAA-shifted pixel centres.
// pix: (T, 3, 256) f32 px | py | tmax per 256-pixel tile. K1: each
// lane makes its pixel's ray, then the warp walk and write_full as K4
// (a lane past R, with h.t = 0, only takes part in the walk).
__global__ void primary_kernel(const float* __restrict__ slabs, int rows,
                               const float* __restrict__ bounds,
                               const int* __restrict__ meta,
                               const float* __restrict__ pix, int R,
                               const float* __restrict__ cam,
                               uint32_t frame_index, float t_min,
                               float* __restrict__ out,
                               int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    Hit h = {0.0f, 0.0f, 0.0f, -1};  // k >= R: no ray, it never walks
    if (k < R) {
        const float* p = pix + (size_t)(k >> 8) * 3 * 256 + (k & 255);
        float px = p[0], py = p[256];
        h.t = p[512];
        // per-pixel jitter = rnd2d01(make_state(px, py, frame)), converted
        // exactly (u32 -> f32 round-to-nearest, then * 2^-32)
        uint32_t x = (uint32_t)(int)px, y = (uint32_t)(int)py, z = frame_index;
        pcg3d(x, y, z);
        float jx = __uint2float_rn(x) * 2.3283064365386963e-10f;
        float jy = __uint2float_rn(y) * 2.3283064365386963e-10f;
        float ux = (px + cam[16] * jx + cam[14]) / cam[12];
        float uy = (py + cam[16] * jy + cam[15]) / cam[13];
        r.dx = ux * cam[3] + uy * cam[6] + cam[9];
        r.dy = ux * cam[4] + uy * cam[7] + cam[10];
        r.dz = ux * cam[5] + uy * cam[8] + cam[11];
        float inv_n = 1.0f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
        r.dx = r.dx * inv_n;
        r.dy = r.dy * inv_n;
        r.dz = r.dz * inv_n;
        r.ox = cam[0];
        r.oy = cam[1];
        r.oz = cam[2];
        set_inv(r);
    }
    warp_walk<false, false>(slabs, rows, bounds, meta, r, t_min, nullptr, h,
                            err);
    if (k < R) write_full(slabs, rows, h, out + 16 * (size_t)k);
}

// K10, the dense-cull any hit (trace_bvh.py _any_body(dense=True) :1617,
// _make_descent_dense :370). One block of DENSE_TILE threads per 128
// consecutive rays, the JAX default packet (tile=128, :1819):
// 1. the packet's rays (origin, reciprocal direction, t_max) are staged
//    in shared memory; a lane with t_max <= t_min, which no hit can
//    occlude, stages t_max = 0 and takes no part;
// 2. the dense cull: each thread takes clusters tid, tid + 128, ... and
//    tests its leaf box (bounds[node_of[c]], the box K3's walk tests at
//    that leaf) against the packet's rays with K3's slab test (enter <=
//    exit, enter < t_max), stopping at the first ray that enters; the
//    entered live clusters are compacted, in id order, into a list in
//    shared memory (one int per cluster: 8 KB at C = 2048). Dead
//    clusters (live[c] == 0, the skip mask) are never listed and pad
//    clusters do not exist, so neither is ever read. JAX keeps each
//    cluster's minimum entry over the packet to pop the nearest one
//    first; that order only steers when a closest-hit walk may stop, and
//    any order gives an any hit the same mask, so the list keeps no keys;
// 3. each warp walks the list on its own: a lane still unoccluded retests
//    the cluster's leaf box against its own ray (node_test on
//    node_of[c], :443), and the lanes that enter it run Möller over its
//    128 triangles (reading the same slab words at once, one broadcast
//    per load) until their first hit. A warp stops when all its lanes are
//    occluded or out (the any-hit exit of :371-373), with no block
//    barrier in the walk.
// The mask equals K3's: a ray is tested against every cluster whose leaf
// box it enters, and the packet cull lists each of them.
#define DENSE_TILE 128
#define DENSE_WARPS (DENSE_TILE / 32)

// Steps 1 and 2 of the dense kernels, shared by K10 and K9: stage the
// packet's rays, cull every live cluster's leaf box against them and
// compact the entered clusters, in id order, into s_list. Returns the
// list's length.
__device__ __forceinline__ int dense_cull(
    int C, const float* __restrict__ bounds, const int* __restrict__ node_of,
    const uint8_t* __restrict__ live, const Ray& r, bool can_hit, float tmax,
    int* s_list, float (*s_ray)[DENSE_TILE], int* s_wcount) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    s_ray[0][tid] = r.ox;
    s_ray[1][tid] = r.oy;
    s_ray[2][tid] = r.oz;
    s_ray[3][tid] = r.ix;
    s_ray[4][tid] = r.iy;
    s_ray[5][tid] = r.iz;
    s_ray[6][tid] = can_hit ? tmax : 0.0f;  // enter >= 0 is never < 0
    __syncthreads();

    // 2. the dense cull of every cluster, compacted in id order
    int count = 0;
    for (int base = 0; base < C; base += DENSE_TILE) {
        const int c = base + tid;
        bool ok = false;
        if (c < C && (live == nullptr || __ldg(live + c) != 0)) {
            const float* b = bounds + 6 * __ldg(node_of + c);
            const float b0 = __ldg(b + 0), b1 = __ldg(b + 1),
                        b2 = __ldg(b + 2), b3 = __ldg(b + 3),
                        b4 = __ldg(b + 4), b5 = __ldg(b + 5);
            for (int i = 0; i < DENSE_TILE && !ok; ++i) {
                const float ox = s_ray[0][i], oy = s_ray[1][i];
                const float oz = s_ray[2][i], ix = s_ray[3][i];
                const float iy = s_ray[4][i], iz = s_ray[5][i];
                float t0x = (b0 - ox) * ix;
                float t1x = (b3 - ox) * ix;
                float t0y = (b1 - oy) * iy;
                float t1y = (b4 - oy) * iy;
                float t0z = (b2 - oz) * iz;
                float t1z = (b5 - oz) * iz;
                float en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fmaxf(fminf(t0z, t1z), 0.0f));
                float ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z));
                ok = en <= ex && en < s_ray[6][i];
            }
        }
        unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) s_wcount[warp] = __popc(bal);
        __syncthreads();
        int off = count, total = 0;
        for (int w = 0; w < DENSE_WARPS; ++w) {
            int n = s_wcount[w];
            off += w < warp ? n : 0;
            total += n;
        }
        if (ok) s_list[off + __popc(bal & ((1u << lane) - 1u))] = c;
        count += total;
        __syncthreads();  // s_wcount is rewritten by the next chunk
    }
    return count;
}

__global__ void __launch_bounds__(DENSE_TILE)
dense_any_kernel(const float* __restrict__ slabs, int rows, int C,
                 const float* __restrict__ bounds,
                 const int* __restrict__ node_of,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ ray_o,
                 const float* __restrict__ ray_d,
                 const float* __restrict__ t_max, int R, float t_min,
                 uint8_t* __restrict__ occ) {
    extern __shared__ int s_list[];  // C
    __shared__ float s_ray[7][DENSE_TILE];  // ox oy oz ix iy iz t_max
    __shared__ int s_wcount[DENSE_WARPS];
    const int k = blockIdx.x * DENSE_TILE + threadIdx.x;
    const bool active = k < R;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float tmax = 0.0f;
    if (active) {
        load_ray(ray_o, ray_d, k, r);
        tmax = t_max[k];
    }
    const bool can_hit = active && tmax > t_min;
    const int count = dense_cull(C, bounds, node_of, live, r, can_hit, tmax,
                                 s_list, s_ray, s_wcount);

    // 3. the walk, warp by warp
    bool done = !can_hit, hit = false;
    for (int i = 0; i < count; ++i) {
        if (__all_sync(0xffffffffu, done)) break;
        const int c = s_list[i];
        float en;
        const bool need =
            !done && node_test(bounds, __ldg(node_of + c), r, tmax, en);
        if (!__any_sync(0xffffffffu, need)) continue;
        if (need) {
            const float* s = slabs + (size_t)c * rows * LANES;
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                if (moller(s, j, r, t_min, tmax, t, u, v)) {
                    hit = done = true;
                    break;
                }
            }
        }
    }
    if (active) occ[k] = hit ? 1 : 0;
}

// K9, the dense-cull closest hit (trace_bvh.py trace_closest_bvh_dense
// :1144, _closest_body(dense=True), _make_descent_dense :370): K10's
// steps 1 and 2, then each warp walks the list in id order with no block
// barrier; a lane retests the cluster's leaf box against its own best t
// (node_test, the test K2 makes at that leaf) and, when it enters before
// it, runs Möller over the 128 triangles with a strict t < best. The
// list in id order and the lanes in order give the lowest tri among
// exact t ties. JAX pops the clusters nearest first and stops once the
// nearest entry lies beyond every ray's best t; the id order tests more
// clusters and finds the same hit. Output: K2's (R, 8) rows, a miss has
// t = t_max and tri = -1.
__global__ void __launch_bounds__(DENSE_TILE)
dense_closest_kernel(const float* __restrict__ slabs, int rows, int C,
                     const float* __restrict__ bounds,
                     const int* __restrict__ node_of,
                     const uint8_t* __restrict__ live,
                     const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d,
                     const float* __restrict__ t_max, int R, float t_min,
                     float* __restrict__ out) {
    extern __shared__ int s_list[];  // C
    __shared__ float s_ray[7][DENSE_TILE];  // ox oy oz ix iy iz t_max
    __shared__ int s_wcount[DENSE_WARPS];
    const int k = blockIdx.x * DENSE_TILE + threadIdx.x;
    const bool active = k < R;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float tmax = 0.0f;
    if (active) {
        load_ray(ray_o, ray_d, k, r);
        tmax = t_max[k];
    }
    const bool can_hit = active && tmax > t_min;
    const int count = dense_cull(C, bounds, node_of, live, r, can_hit, tmax,
                                 s_list, s_ray, s_wcount);

    Hit h = {tmax, 0.0f, 0.0f, -1};
    for (int i = 0; i < count; ++i) {
        const int c = s_list[i];
        float en;
        const bool need =
            can_hit && node_test(bounds, __ldg(node_of + c), r, h.t, en);
        if (!__any_sync(0xffffffffu, need)) continue;
        if (need) {
            const float* s = slabs + (size_t)c * rows * LANES;
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                if (moller(s, j, r, t_min, h.t, t, u, v)) {
                    h.t = t;
                    h.u = u;
                    h.v = v;
                    h.tri = c * LANES + j;
                }
            }
        }
    }
    if (!active) return;
    float* o = out + 8 * (size_t)k;
    o[0] = h.t;
    o[1] = (float)h.tri;
    o[2] = h.u;
    o[3] = h.v;
    o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// ---------------------------------------------------------------------------
// K11-K13: the 8-wide walks over pack_nodes8 tables (trace_bvh.py
// trace_closest_bvh8 :1918, trace_closest_bvh8_full :1948, trace_any_bvh8
// :1977). nodes8 (N8, 8, 8) f32: node n, slot c = [min.xyz | max.xyz | enc
// | 0], enc >= 0 an internal child's node, enc < 0 leaf cluster -(enc+1),
// an empty slot NaN bounds and enc 0. The Pallas kernels test the 8 slots
// against 128 rays in one (8, 128) op and sort key frames; here one thread
// walks one ray: it loads a node's 8 slots (256 B, as float4s), slab-tests
// each against its current best t, skips an empty slot by its NaN (fminf
// and fmaxf return the non-NaN operand, so an empty slot's entry is 0, as
// a box the ray starts in; only its NaN exit keeps the slab test from
// entering it, and the walk would re-enter the root at enc 0), orders the
// entered children near-first with a 19-comparator network in registers
// and pushes them farthest first. A leaf runs Möller over the cluster's
// 128 lanes. The closest walks keep the lexicographic minimum of (t, tri):
// a node whose entry equals the best t is still visited and a tie goes to
// the lower tri id, so the result is the plain brute force's, whatever the
// visit order. Bound as K2-K4: divergent walks and scattered slab reads.
#define STACK8_CAP 128  // >= 7 * (8-wide depth) + 1 (trace_bvh.STACK8_CAP)
#define NO_CHILD (-2147483647 - 1)

// Slab test of one slot (a = min.xyz | max.x, b = max.yz | enc | 0)
// against the ray's best t: node_test's arithmetic, with the closest
// walks also keeping an entry equal to a best t that is a hit.
template <bool ANY>
__device__ __forceinline__ bool slot_test(const float4& a, const float4& b,
                                          const Ray& r, const Hit& h,
                                          float& enter) {
    float t0x = (a.x - r.ox) * r.ix;
    float t1x = (a.w - r.ox) * r.ix;
    float t0y = (a.y - r.oy) * r.iy;
    float t1y = (b.x - r.oy) * r.iy;
    float t0z = (a.z - r.oz) * r.iz;
    float t1z = (b.y - r.oz) * r.iz;
    float en = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), 0.0f));
    float ex = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fmaxf(t0z, t1z));
    enter = en;
    return en <= ex && (en < h.t || (!ANY && h.tri >= 0 && en == h.t));
}

// enc rides as f32: the sign first, then a rounding cast of |enc|.
__device__ __forceinline__ int slot_enc(float e) {
    return e < 0.0f ? -__float2int_rn(-e) : __float2int_rn(e);
}

#define CE(i, j)                                                      \
    if (key[j] < key[i]) {                                            \
        float tk = key[i];                                            \
        key[i] = key[j];                                              \
        key[j] = tk;                                                  \
        int tv = val[i];                                              \
        val[i] = val[j];                                              \
        val[j] = tv;                                                  \
    }

// The 8-wide walk. ANY=true stops at the first hit. Returns false on
// stack overflow.
template <bool ANY>
__device__ bool walk8(const float* __restrict__ slabs, int rows,
                      const float4* __restrict__ nodes8, const Ray& r,
                      float t_min, Hit& h) {
    int stack_enc[STACK8_CAP];
    float stack_enter[STACK8_CAP];
    stack_enc[0] = 0;  // the root node: its slots carry the boxes
    stack_enter[0] = 0.0f;
    int sp = 1;
    while (sp > 0) {
        --sp;
        const int enc = stack_enc[sp];
        const float en0 = stack_enter[sp];
        // pruned by a closer hit (an equal one may still lose a tie)
        if (!(en0 < h.t || (!ANY && h.tri >= 0 && en0 == h.t))) continue;
        if (enc < 0) {
            const int leaf = -enc - 1;
            const float* s = slabs + (size_t)leaf * rows * LANES;
            for (int j = 0; j < LANES; ++j) {
                float t, u, v;
                if (ANY) {
                    if (moller(s, j, r, t_min, h.t, t, u, v)) {
                        h.tri = leaf * LANES + j;
                        return true;
                    }
                } else if (moller(s, j, r, t_min, INF, t, u, v)) {
                    const int tri = leaf * LANES + j;
                    if (t < h.t || (t == h.t && h.tri >= 0 && tri < h.tri)) {
                        h.t = t;
                        h.u = u;
                        h.v = v;
                        h.tri = tri;
                    }
                }
            }
            continue;
        }
        const float4* nd = nodes8 + (size_t)enc * 16;
        float key[8];
        int val[8];
        int n = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float4 a = __ldg(nd + 2 * c);
            const float4 b = __ldg(nd + 2 * c + 1);
            float en;
            const bool in = !isnan(a.x) && slot_test<ANY>(a, b, r, h, en);
            key[c] = in ? en : INF;
            val[c] = in ? slot_enc(b.z) : NO_CHILD;
            n += in ? 1 : 0;
        }
        if (n == 0) continue;
        if (sp + n > STACK8_CAP) return false;
        // near first: ascending entry t
        CE(0, 2) CE(1, 3) CE(4, 6) CE(5, 7)
        CE(0, 4) CE(1, 5) CE(2, 6) CE(3, 7)
        CE(0, 1) CE(2, 3) CE(4, 5) CE(6, 7)
        CE(2, 4) CE(3, 5)
        CE(1, 4) CE(3, 6)
        CE(1, 2) CE(3, 4) CE(5, 6)
        // push the farthest first so the nearest pops next
#pragma unroll
        for (int c = 7; c >= 0; --c) {
            if (val[c] != NO_CHILD) {
                stack_enc[sp] = val[c];
                stack_enter[sp] = key[c];
                ++sp;
            }
        }
    }
    return true;
}
#undef CE

// K11: (R, 8) rows t | tri | u | v | pad; a miss has t = t_max, tri = -1.
__global__ void closest8_kernel(const float* __restrict__ slabs, int rows,
                                const float4* __restrict__ nodes8,
                                const float* __restrict__ ray_o,
                                const float* __restrict__ ray_d,
                                const float* __restrict__ t_max, int R,
                                float t_min, float* __restrict__ out,
                                int* __restrict__ err) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= R) return;
    Ray r;
    load_ray(ray_o, ray_d, k, r);
    Hit h = {t_max[k], 0.0f, 0.0f, -1};
    if (h.t > 0.0f && !walk8<false>(slabs, rows, nodes8, r, t_min, h))
        atomicExch(err, 1);
    float* o = out + 8 * (size_t)k;
    o[0] = h.t;
    o[1] = (float)h.tri;
    o[2] = h.u;
    o[3] = h.v;
    o[4] = o[5] = o[6] = o[7] = 0.0f;
}

// K12: K11's walk and write_full's (R, 16) rows (K4's, without a mask).
__global__ void closest8_full_kernel(const float* __restrict__ slabs,
                                     int rows,
                                     const float4* __restrict__ nodes8,
                                     const float* __restrict__ ray_o,
                                     const float* __restrict__ ray_d,
                                     const float* __restrict__ t_max, int R,
                                     float t_min, float* __restrict__ out,
                                     int* __restrict__ err) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= R) return;
    Ray r;
    load_ray(ray_o, ray_d, k, r);
    Hit h = {t_max[k], 0.0f, 0.0f, -1};
    if (h.t > 0.0f && !walk8<false>(slabs, rows, nodes8, r, t_min, h))
        atomicExch(err, 1);
    write_full(slabs, rows, h, out + 16 * (size_t)k);
}

// K13: (R,) occlusion, a hit being t_min < t < t_max.
__global__ void any8_kernel(const float* __restrict__ slabs, int rows,
                            const float4* __restrict__ nodes8,
                            const float* __restrict__ ray_o,
                            const float* __restrict__ ray_d,
                            const float* __restrict__ t_max, int R,
                            float t_min, uint8_t* __restrict__ occ,
                            int* __restrict__ err) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= R) return;
    Ray r;
    load_ray(ray_o, ray_d, k, r);
    Hit h = {t_max[k], 0.0f, 0.0f, -1};
    if (h.t > 0.0f && !walk8<true>(slabs, rows, nodes8, r, t_min, h))
        atomicExch(err, 1);
    occ[k] = h.tri >= 0 ? 1 : 0;
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

// Dynamic shared memory of a dense kernel: the list, one int a cluster.
template <typename Kernel>
inline int dense_smem(Kernel kernel, int C, size_t& bytes) {
    bytes = sizeof(int) * (size_t)C;
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// C entry points: launch on `stream`, never synchronise, return
// cudaGetLastError() (0 on success). `err` is a device int, shared by
// all launches on the device, set to 1 when a ray overflows its stack;
// the host reads and clears it once per frame.

extern "C" int trace_closest_bvh(const float* slabs, int rows,
                                 const float* bounds, const int* meta,
                                 const float* ray_o, const float* ray_d,
                                 const float* t_max, int R, float t_min,
                                 float* out, int* err, void* stream) {
    if (R > 0)
        warp_closest_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, out, err);
    return (int)cudaGetLastError();
}

// X3a: K2 with per-ray counts in pad rows 6 (nodes) and 7 (leaves).
extern "C" int trace_closest_bvh_visits(const float* slabs, int rows,
                                        const float* bounds, const int* meta,
                                        const float* ray_o,
                                        const float* ray_d,
                                        const float* t_max, int R,
                                        float t_min, float* out, int* err,
                                        void* stream) {
    if (R > 0)
        closest_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, out, err);
    return (int)cudaGetLastError();
}

extern "C" int trace_any_bvh(const float* slabs, int rows, const float* bounds,
                             const int* meta, const float* ray_o,
                             const float* ray_d, const float* t_max, int R,
                             float t_min, uint8_t* occ, int* err,
                             void* stream) {
    if (R > 0)
        warp_any_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, occ, err);
    return (int)cudaGetLastError();
}

// K10 needs no node stack, so it takes no overflow flag; the list's
// shared memory is checked by the host against a block's 227 KB.
extern "C" int trace_any_bvh_dense(const float* slabs, int rows, int C,
                                   const float* bounds, const int* node_of,
                                   const uint8_t* live, const float* ray_o,
                                   const float* ray_d, const float* t_max,
                                   int R, float t_min, uint8_t* occ,
                                   void* stream) {
    if (R <= 0) return 0;
    size_t bytes;
    int e = dense_smem(dense_any_kernel, C, bytes);
    if (e != 0) return e;
    dense_any_kernel<<<(R + DENSE_TILE - 1) / DENSE_TILE, DENSE_TILE, bytes,
                       (cudaStream_t)stream>>>(slabs, rows, C, bounds,
                                               node_of, live, ray_o, ray_d,
                                               t_max, R, t_min, occ);
    return (int)cudaGetLastError();
}

// K9: as K10, with (R, 8) closest-hit rows.
extern "C" int trace_closest_bvh_dense(const float* slabs, int rows, int C,
                                       const float* bounds,
                                       const int* node_of,
                                       const uint8_t* live,
                                       const float* ray_o,
                                       const float* ray_d,
                                       const float* t_max, int R,
                                       float t_min, float* out,
                                       void* stream) {
    if (R <= 0) return 0;
    size_t bytes;
    int e = dense_smem(dense_closest_kernel, C, bytes);
    if (e != 0) return e;
    dense_closest_kernel<<<(R + DENSE_TILE - 1) / DENSE_TILE, DENSE_TILE,
                           bytes, (cudaStream_t)stream>>>(
        slabs, rows, C, bounds, node_of, live, ray_o, ray_d, t_max, R, t_min,
        out);
    return (int)cudaGetLastError();
}

extern "C" int trace_closest_bvh_full(const float* slabs, int rows,
                                      const float* bounds, const int* meta,
                                      const float* ray_o, const float* ray_d,
                                      const float* t_max, int R, float t_min,
                                      const uint8_t* live, float* out,
                                      int* err, void* stream) {
    if (R > 0)
        closest_full_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, live,
            out, err);
    return (int)cudaGetLastError();
}

// K11-K13 (nodes8 16-byte aligned, checked by the host).
extern "C" int trace_closest_bvh8(const float* slabs, int rows,
                                  const float* nodes8, const float* ray_o,
                                  const float* ray_d, const float* t_max,
                                  int R, float t_min, float* out, int* err,
                                  void* stream) {
    if (R > 0)
        closest8_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, (const float4*)nodes8, ray_o, ray_d, t_max, R,
            t_min, out, err);
    return (int)cudaGetLastError();
}

extern "C" int trace_closest_bvh8_full(const float* slabs, int rows,
                                       const float* nodes8,
                                       const float* ray_o, const float* ray_d,
                                       const float* t_max, int R, float t_min,
                                       float* out, int* err, void* stream) {
    if (R > 0)
        closest8_full_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, (const float4*)nodes8, ray_o, ray_d, t_max, R,
            t_min, out, err);
    return (int)cudaGetLastError();
}

extern "C" int trace_any_bvh8(const float* slabs, int rows,
                              const float* nodes8, const float* ray_o,
                              const float* ray_d, const float* t_max, int R,
                              float t_min, uint8_t* occ, int* err,
                              void* stream) {
    if (R > 0)
        any8_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, (const float4*)nodes8, ray_o, ray_d, t_max, R,
            t_min, occ, err);
    return (int)cudaGetLastError();
}

extern "C" int trace_primary_bvh_full(const float* slabs, int rows,
                                      const float* bounds, const int* meta,
                                      const float* pix, int R,
                                      const float* cam, int frame_index,
                                      float t_min, float* out, int* err,
                                      void* stream) {
    if (R > 0)
        primary_kernel<<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
            slabs, rows, bounds, meta, pix, R, cam, (uint32_t)frame_index,
            t_min, out, err);
    return (int)cudaGetLastError();
}
