// BVH ray-trace kernels for Hopper (sm_90a): the port of the six Pallas
// TPU kernels of ops/trace_bvh.py over BVH2 node arrays and of its three
// over 8-wide node tables (trace_closest_bvh8, trace_closest_bvh8_full,
// trace_any_bvh8: K11-K13 below).
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
//                           rows with per-ray node and leaf counts
//                           (X3a, warp_closest_kernel<true>).
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
// The walk. Each ray walks the BVH near-first on its own stack of STACK_CAP
// nodes in local memory, pruning against its best t, with the Möller test
// written operation for operation as the plain PyTorch version (compiled
// with --fmad=false) so hits agree bit for bit. A leaf's 128 tests must not
// run on the ray's own thread: each test would issue 9 scalar loads of that
// thread's cluster, so in a warp whose lanes sit in up to 32 clusters a load
// would touch up to 32 cache lines, and the warp would run a 128-test round
// whenever any lane is at a leaf while the others idle. K1-K4 and X3a
// (`warp_walk`) share the leaf tests instead: a lane walks its own ray's
// interior nodes until it pops a leaf, which it holds pending (K4 drops a
// leaf of a masked cluster on pop, unread); when every lane holds one or is
// done, the warp tests the pending leaves one owner at a time, all 32 lanes
// on each, 4 triangles a lane and every slab load one full 128-byte line
// across the warp. A warp's tests then scale with the leaves its rays visit,
// not with 128 times the most any lane visits. Each ray's pops, prunes and
// leaf tests stay those of its own walk, so the rows equal the lockstep
// plain walk's (ops/trace_bvh.py trace_closest_bvh_visits_plain) bit for
// bit, and X3a's counts, kept by the same code (COUNT), equal its counts.
// What bounds the walk is the leaf tests' FP32 work, in which each test's
// IEEE division keeps its branch, and the lanes' dependent node loads, which
// the warp's other lanes overlap only while they too are walking; X3a adds
// two counters in registers. K10 and K9 test the clusters of their dense
// list with the same warp-shared leaf test (warp_leaf). K11-K13
// (warp_walk8) walk 8-wide nodes per lane and share the same leaf round
// (leaf_round): K11 and K12 under the (t, tri) tie rule of their plain
// versions, K13 with K3's any-hit test; they are bound by the lanes'
// 8-wide interior steps and the leaf tests. Node layouts, persistent
// threads, ray reordering and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define STACK_CAP 64  // >= BVH depth + 2 (trace_bvh.py:52)
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

struct Hit {
    float t, u, v;
    int tri;
};

// A ray's walk counts (X3a): interior nodes expanded, leaves tested.
struct Visits {
    int nodes, leaves;
};

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

// One lane's near-first walk up to its next leaf: pops, prunes an entry
// against best, tests an interior node's two children against best and
// pushes the far one first, until it pops a leaf, whose cluster it
// returns, or its stack is empty (-1). LIVE: a popped leaf whose cluster
// has live[cluster] == 0 is dropped there, unread (live == nullptr: every
// cluster is live). COUNT: adds each interior node it expands to
// n->nodes. On stack overflow sets ok = false and empties the stack.
template <bool LIVE, bool COUNT>
__device__ __forceinline__ int next_leaf(const float* __restrict__ bounds,
                                         const int* __restrict__ meta,
                                         const uint8_t* __restrict__ live,
                                         const Ray& r, float best,
                                         int* stack_node, float* stack_enter,
                                         int& sp, bool& ok, Visits* n) {
    while (sp > 0) {
        --sp;
        const int i = stack_node[sp];
        if (stack_enter[sp] >= best) continue;  // pruned by a closer hit
        const int leaf = __ldg(meta + 3 * i + 2);
        if (leaf >= 0) {
            if (LIVE && live != nullptr && __ldg(live + leaf) == 0) continue;
            return leaf;
        }
        if (COUNT) ++n->nodes;
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

// The warp-shared leaf test of K1-K4, K9-K13. Every lane of the warp
// calls it with the same src, the owner: lane src's ray, with best t
// h.t, is tested against cluster `leaf` of lane src. ANY=true: returns
// on every lane whether some triangle hits (t_min < t < best;
// ray_common.cuh warp_any, which K7 shares), and the owner sets h.tri =
// leaf * LANES (occluded). Otherwise returns whether some triangle hits,
// and the owner takes the hit by the rule below.
//
// Lane l tests triangles l + 32q (q = 0..3) against the owner's ray with
// t_upper = best, every slab load one full 128-byte line across the
// warp, and keeps its lowest t, the lowest j among equal t; the warp
// takes the minimum key of t, then the lowest j among the lanes at that
// key. A loop over j = 0..127 with a strict t < best would keep the
// same triangle: the lowest t below best and, among equal t, the lowest
// j. Every hit lies below best, so the owner always takes it, and a
// later cluster's equal t never replaces it: the earlier visit keeps a
// tie across clusters (K1-K4, K9, X3a).
//
// LEXMIN (K11, K12): the (t, tri) rule of the 8-wide walk, whose rows
// are the lexicographic minimum of (t, tri) over every entered leaf box.
// The lanes test with t_upper = INF, so the warp's pick is the cluster's
// lowest (t, j), and the owner takes it when t < h.t, or t == h.t and
// the tri is lower than a hit it holds: what a loop over j = 0..127 with
// that comparison and t_upper = INF keeps, since a triangle the pick
// beats in (t, tri) could not have replaced the pick.
template <bool ANY, bool LEXMIN = false>
__device__ __forceinline__ bool warp_leaf(const float* __restrict__ slabs,
                                          int rows, int leaf, int src,
                                          const Ray& r, float t_min, Hit& h) {
    const int lane = threadIdx.x & 31;
    const Ray q = owner_ray(r, src);
    const float best = __shfl_sync(FULL_MASK, h.t, src);
    const int c = __shfl_sync(FULL_MASK, leaf, src);
    if (ANY) {
        const bool any = warp_any(slabs, rows, c, q, t_min, best);
        if (any && lane == src) h.tri = c * LANES;
        return any;
    }
    const float t_upper = LEXMIN ? INF : best;
    const float* s = slabs + (size_t)c * rows * LANES + lane;
    float bt = t_upper, bu = 0.0f, bv = 0.0f;
    int bj = -1;
#pragma unroll
    for (int j = 0; j < LANES; j += 32) {
        float t, u, v;
        if (moller(s, j, q, t_min, t_upper, t, u, v) && t < bt) {
            bt = t;
            bu = u;
            bv = v;
            bj = lane + j;
        }
    }
    const unsigned key = bj >= 0 ? t_key(bt) : NO_KEY;
    const unsigned kmin = __reduce_min_sync(FULL_MASK, key);
    if (kmin == NO_KEY) return false;
    const unsigned j =
        __reduce_min_sync(FULL_MASK, key == kmin ? (unsigned)bj : NO_KEY);
    const int w = (int)(j & 31u);
    const float t = __shfl_sync(FULL_MASK, bt, w);
    const float u = __shfl_sync(FULL_MASK, bu, w);
    const float v = __shfl_sync(FULL_MASK, bv, w);
    const int tri = c * LANES + (int)j;
    if (lane == src &&
        (!LEXMIN || t < h.t || (t == h.t && h.tri >= 0 && tri < h.tri))) {
        h.t = t;
        h.u = u;
        h.v = v;
        h.tri = tri;
    }
    return true;
}

// A leaf round of the warp walks: when some lane holds a pending leaf
// (leaf >= 0), the warp tests each, lowest owner lane first, with
// warp_leaf<ANY, LEXMIN>, and returns true; false when no lane holds
// one. ANY: an owner with a hit is occluded, and its stack is emptied.
// COUNT: the owner adds the leaf to n->leaves.
template <bool ANY, bool LEXMIN, bool COUNT>
__device__ __forceinline__ bool leaf_round(const float* __restrict__ slabs,
                                           int rows, int leaf, const Ray& r,
                                           float t_min, Hit& h, int& sp,
                                           Visits* n) {
    const int lane = threadIdx.x & 31;
    unsigned pending = __ballot_sync(FULL_MASK, leaf >= 0);
    if (pending == 0) return false;
    do {  // the pending leaves, lowest owner lane first
        const int src = __ffs(pending) - 1;
        pending &= pending - 1;
        if (COUNT && lane == src) ++n->leaves;
        if (warp_leaf<ANY, LEXMIN>(slabs, rows, leaf, src, r, t_min, h) &&
            ANY && lane == src)
            sp = 0;  // occluded: the owner is done
    } while (pending != 0);
    return true;
}

// K1-K4's and X3a's walk: next_leaf per lane, the leaf tests by the
// whole warp (warp_leaf). Every thread of the warp calls it, a lane
// without a ray with h.t = 0 (it never enters the root), and stays to
// the end: each _sync takes the full mask. ANY=true: the owner of a leaf
// with any hit is done, and h.tri >= 0 marks it occluded (K3). LIVE: the
// skip mask `live` (K4). COUNT: the lane's counts in *n (X3a; n may be
// null otherwise). Sets *err on stack overflow.
template <bool ANY, bool LIVE, bool COUNT = false>
__device__ void warp_walk(const float* __restrict__ slabs, int rows,
                          const float* __restrict__ bounds,
                          const int* __restrict__ meta, const Ray& r,
                          float t_min, const uint8_t* __restrict__ live,
                          Hit& h, int* __restrict__ err,
                          Visits* n = nullptr) {
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
        const int leaf = next_leaf<LIVE, COUNT>(
            bounds, meta, live, r, h.t, stack_node, stack_enter, sp, ok, n);
        if (!leaf_round<ANY, false, COUNT>(slabs, rows, leaf, r, t_min, h, sp,
                                           n))
            break;
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

// K2 (COUNT = false): (R, 8) rows t | tri | u | v | pad; a miss has t =
// t_max, tri = -1. X3a (COUNT = true, K2 with DEBUG_VISITS,
// scripts/bench_visit_breakdown.py:148, trace_bvh.py:941): the same rows
// with the interior nodes the ray expands in pad row 6 and the leaves it
// tests in pad row 7 (JAX writes each packet's leaf visits into row 7).
// A lane holds its popped leaf until the warp has tested it, so its best
// t is the same at the pop and at the test, and its pops, prunes and
// tests, and so its counts, are those of the ray's own walk.
template <bool COUNT>
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
    Visits n = {0, 0};
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk<false, false, COUNT>(slabs, rows, bounds, meta, r, t_min,
                                   nullptr, h, err, &n);
    if (k >= R) return;
    float* o = out + 8 * (size_t)k;
    o[0] = h.t;
    o[1] = (float)h.tri;
    o[2] = h.u;
    o[3] = h.v;
    o[4] = o[5] = 0.0f;
    o[6] = COUNT ? (float)n.nodes : 0.0f;
    o[7] = COUNT ? (float)n.leaves : 0.0f;
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
    if (k < R)
        write_full(slabs, rows, h.t, h.tri, h.u, h.v, out + 16 * (size_t)k);
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
    if (k < R)
        write_full(slabs, rows, h.t, h.tri, h.u, h.v, out + 16 * (size_t)k);
}

// K10, the dense-cull any hit (trace_bvh.py _any_body(dense=True) :1617,
// _make_descent_dense :370). One block of DENSE_TILE threads per 128
// consecutive rays, the JAX default packet (tile=128, :1819):
// 1. the packet's rays (origin, reciprocal direction, t_max) are staged
//    in shared memory; a lane with t_max <= t_min, which no hit can
//    occlude, stages t_max = 0 and takes no part;
// 2. the dense cull (dense_cull): every live cluster whose leaf box
//    (bounds[node_of[c]], the box K3's walk tests at that leaf) some ray
//    of the packet enters with K3's slab test (enter <= exit, enter <
//    t_max) is listed, in id order, in shared memory (one int per
//    cluster: 8 KB at C = 2048). The packet walks the BVH to find them:
//    a node whose box no ray enters is not opened, so most of the 2048
//    leaf boxes are never tested against the 128 rays. Dead clusters
//    (live[c] == 0, the skip mask) are never listed and pad clusters do
//    not exist, so neither is ever read. JAX keeps each cluster's minimum
//    entry over the packet to pop the nearest one first; that order only
//    steers when a closest-hit walk may stop, and any order gives an any
//    hit the same mask, so the list keeps no keys;
// 3. each warp walks the list on its own, with the warp-shared leaf test
//    of K1-K4 (warp_leaf): the lanes still unoccluded that enter the
//    cluster's leaf box (node_test on node_of[c], :443) are its owners;
//    for each owner, lowest lane first, the whole warp tests the owner's
//    ray against the cluster's 128 triangles, 4 a lane on full 128-byte
//    slab lines, and an owner with a hit is occluded and done. A warp
//    leaves the list when all its lanes are occluded or out (the any-hit
//    exit of :371-373), with no block barrier in the walk.
// The mask equals K3's: a ray is tested against every cluster whose leaf
// box it enters, and the packet cull lists each of them.
//
// What bounds it on the H100: the cull's slab tests (up to 128 rays for
// each box the packet's walk opens, from registers) and the walk's
// triangle tests, 4 per lane per owner instead of 128 by each owner lane
// alone.
// dense_cull_kernel, the measurement form that chip_smoke.py alone calls,
// runs steps 1 and 2 and writes each packet's list length, so the cull
// and the walk are timed apart.
#define DENSE_TILE 128
#define DENSE_WARPS (DENSE_TILE / 32)
#define DENSE_ROUNDS (DENSE_TILE / 32)  // rays a lane holds in the cull
#define ROOT_ENTERED 1
#define CULL_OVERFLOW 2
static_assert(DENSE_WARPS == 4, "the cull splits the tree at depth 2");

// Static shared memory of the dense kernels; the dynamic part holds the
// list (C ints) and the bitmap of entered clusters (ceil(C / 32) ints).
struct DenseShared {
    float ray[7][DENSE_TILE];           // ox oy oz ix iy iz t_max
    int wcount[DENSE_WARPS];
    int stack[DENSE_WARPS][STACK_CAP];  // one traversal stack per warp
    int flags;                          // ROOT_ENTERED | CULL_OVERFLOW
};

// Steps 1 and 2 of the dense kernels, shared by K10 and K9: stage the
// packet's rays, find every live cluster whose leaf box some ray of the
// packet enters and compact them, in id order, into s_list. Returns the
// list's length.
//
// The cull walks the BVH for the whole packet: a node's box is tested
// against the packet's rays (lane l holds rays l + 32q, q = 0..3, in
// registers; a round of 32 stops at the first ray that enters), and only
// the children of an entered node are tested; an entered leaf marks its
// cluster in a bitmap. Each warp walks depth first on its own stack; the
// three nodes above depth 2 are tested by every warp, and warp w takes
// the w-th subtree at depth 2. A parent's box holds its children's
// exactly, and the slab test's rounding is monotone in the box, so a ray
// that enters a leaf box enters every box above it: the bitmap holds
// exactly the clusters whose leaf box some ray enters, as the test of
// every leaf box against every ray did. A cluster that no leaf holds
// (node_of = 0, the root) is listed when some ray enters the root's box,
// as that test did; a stack overflow lists every live cluster (the walk
// retests each, so the result stays exact).
__device__ __forceinline__ int dense_cull(
    int C, const float* __restrict__ bounds, const int* __restrict__ meta,
    const int* __restrict__ node_of, const uint8_t* __restrict__ live,
    const Ray& r, bool can_hit, float tmax, int* s_list,
    unsigned* s_bits, DenseShared& sh) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    sh.ray[0][tid] = r.ox;
    sh.ray[1][tid] = r.oy;
    sh.ray[2][tid] = r.oz;
    sh.ray[3][tid] = r.ix;
    sh.ray[4][tid] = r.iy;
    sh.ray[5][tid] = r.iz;
    sh.ray[6][tid] = can_hit ? tmax : 0.0f;  // enter >= 0 is never < 0
    const int words = (C + 31) >> 5;
    for (int w = tid; w < words; w += DENSE_TILE) s_bits[w] = 0u;
    if (tid == 0) sh.flags = 0;
    __syncthreads();

    // 2a. the packet's walk of the BVH, marking the entered live leaves
    float ox[DENSE_ROUNDS], oy[DENSE_ROUNDS], oz[DENSE_ROUNDS];
    float ix[DENSE_ROUNDS], iy[DENSE_ROUNDS], iz[DENSE_ROUNDS];
    float tm[DENSE_ROUNDS];
#pragma unroll
    for (int q = 0; q < DENSE_ROUNDS; ++q) {
        const int i = 32 * q + lane;
        ox[q] = sh.ray[0][i];
        oy[q] = sh.ray[1][i];
        oz[q] = sh.ray[2][i];
        ix[q] = sh.ray[3][i];
        iy[q] = sh.ray[4][i];
        iz[q] = sh.ray[5][i];
        tm[q] = sh.ray[6][i];
    }
    // a stack entry: node | tag << 24; tag 1 the root, 2-3 depth 1, 4-7
    // depth 2 (warp tag - 4 takes it), 8 below
    int* stack = sh.stack[warp];
    if (lane == 0) stack[0] = 1 << 24;
    int sp = 1;
    __syncwarp();
    while (sp > 0) {
        --sp;
        const int e = stack[sp];
        __syncwarp();  // read by every lane before lane 0 reuses the slot
        const int n = e & 0xffffff, tag = e >> 24;
        const float* b = bounds + 6 * n;
        const float lx = __ldg(b), ly = __ldg(b + 1), lz = __ldg(b + 2);
        const float hx = __ldg(b + 3), hy = __ldg(b + 4), hz = __ldg(b + 5);
        bool entered = false;
#pragma unroll
        for (int q = 0; q < DENSE_ROUNDS; ++q) {
            const Ray rq = {ox[q], oy[q], oz[q], 0.0f, 0.0f, 0.0f,
                            ix[q], iy[q], iz[q]};
            float ex;
            const float en = slab_enter(lx, ly, lz, hx, hy, hz, rq, ex);
            if (__any_sync(FULL_MASK, en <= ex && en < tm[q])) {
                entered = true;  // K3's slab test, some ray of the round
                break;
            }
        }
        if (!entered) continue;
        if (tag == 1 && tid == 0) atomicOr(&sh.flags, ROOT_ENTERED);
        const int leaf = __ldg(meta + 3 * n + 2);
        if (leaf >= 0) {
            if (lane == 0 && (live == nullptr || __ldg(live + leaf) != 0))
                atomicOr(s_bits + (leaf >> 5), 1u << (leaf & 31));
            continue;
        }
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            const int ctag = tag >= 4 ? 8 : 2 * tag + side;
            if (ctag >= 4 && ctag < 8 && ctag - 4 != warp) continue;
            if (sp == STACK_CAP) {  // never at BVH depths <= STACK_CAP - 2
                if (lane == 0) atomicOr(&sh.flags, CULL_OVERFLOW);
                sp = 0;
                break;
            }
            if (lane == 0)
                stack[sp] = __ldg(meta + 3 * n + side) | (ctag << 24);
            ++sp;
        }
        __syncwarp();
    }
    __syncthreads();

    // 2b. the marked clusters, compacted in id order
    const int flags = sh.flags;
    const int root_leaf = __ldg(meta + 2);
    int count = 0;
    for (int base = 0; base < C; base += DENSE_TILE) {
        const int c = base + tid;
        bool ok = false;
        if (c < C && (live == nullptr || __ldg(live + c) != 0)) {
            ok = (s_bits[c >> 5] >> (c & 31)) & 1u;
            ok |= (flags & CULL_OVERFLOW) != 0;
            ok |= (flags & ROOT_ENTERED) != 0 && __ldg(node_of + c) == 0 &&
                  root_leaf != c;
        }
        unsigned bal = __ballot_sync(FULL_MASK, ok);
        if (lane == 0) sh.wcount[warp] = __popc(bal);
        __syncthreads();
        int off = count, total = 0;
        for (int w = 0; w < DENSE_WARPS; ++w) {
            int n = sh.wcount[w];
            off += w < warp ? n : 0;
            total += n;
        }
        if (ok) s_list[off + __popc(bal & ((1u << lane) - 1u))] = c;
        count += total;
        __syncthreads();  // wcount is rewritten by the next chunk
    }
    return count;
}

// Step 3 of K10 and K9, the walk: each warp walks the packet's list in
// id order on its own, with no block barrier. A listed cluster's owners
// are the lanes still walking (can_hit; ANY: not yet occluded) whose
// retest of its leaf box (node_test on node_of[c], the test K2-K4 make
// at that leaf) enters before their own best t (t_max for an any hit);
// for each owner, lowest lane first, the whole warp tests the owner's
// ray against the cluster's 128 triangles (warp_leaf<ANY>: 4 a lane, on
// full 128-byte slab lines). A warp leaves the list once none of its
// lanes is walking.
template <bool ANY>
__device__ __forceinline__ void dense_walk(const float* __restrict__ slabs,
                                           int rows,
                                           const float* __restrict__ bounds,
                                           const int* __restrict__ node_of,
                                           const int* s_list, int count,
                                           const Ray& r, bool can_hit,
                                           float t_min, Hit& h) {
    for (int i = 0; i < count; ++i) {
        const bool done = !can_hit || (ANY && h.tri >= 0);
        if (__all_sync(FULL_MASK, done)) break;
        const int c = s_list[i];
        float en;
        unsigned owners = __ballot_sync(
            FULL_MASK,
            !done && node_test(bounds, __ldg(node_of + c), r, h.t, en));
        while (owners != 0) {
            const int src = __ffs(owners) - 1;
            owners &= owners - 1;
            warp_leaf<ANY>(slabs, rows, c, src, r, t_min, h);
        }
    }
}

__global__ void __launch_bounds__(DENSE_TILE)
dense_any_kernel(const float* __restrict__ slabs, int rows, int C,
                 const float* __restrict__ bounds,
                 const int* __restrict__ meta,
                 const int* __restrict__ node_of,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ ray_o,
                 const float* __restrict__ ray_d,
                 const float* __restrict__ t_max, int R, float t_min,
                 uint8_t* __restrict__ occ) {
    extern __shared__ int s_list[];  // C, then the bitmap
    __shared__ DenseShared sh;
    const int k = blockIdx.x * DENSE_TILE + threadIdx.x;
    const bool active = k < R;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float tmax = 0.0f;
    if (active) {
        load_ray(ray_o, ray_d, k, r);
        tmax = t_max[k];
    }
    const bool can_hit = active && tmax > t_min;
    const int count =
        dense_cull(C, bounds, meta, node_of, live, r, can_hit, tmax, s_list,
                   reinterpret_cast<unsigned*>(s_list + C), sh);

    Hit h = {tmax, 0.0f, 0.0f, -1};  // h.tri >= 0: occluded
    dense_walk<true>(slabs, rows, bounds, node_of, s_list, count, r,
                     can_hit, t_min, h);
    if (active) occ[k] = h.tri >= 0 ? 1 : 0;
}

// The measurement form of K10's cull: steps 1 and 2 alone, then each
// packet's list length into counts[blockIdx.x].
__global__ void __launch_bounds__(DENSE_TILE)
dense_cull_kernel(int C, const float* __restrict__ bounds,
                  const int* __restrict__ meta,
                  const int* __restrict__ node_of,
                  const uint8_t* __restrict__ live,
                  const float* __restrict__ ray_o,
                  const float* __restrict__ ray_d,
                  const float* __restrict__ t_max, int R, float t_min,
                  int* __restrict__ counts) {
    extern __shared__ int s_list[];  // C, then the bitmap
    __shared__ DenseShared sh;
    const int k = blockIdx.x * DENSE_TILE + threadIdx.x;
    const bool active = k < R;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float tmax = 0.0f;
    if (active) {
        load_ray(ray_o, ray_d, k, r);
        tmax = t_max[k];
    }
    const bool can_hit = active && tmax > t_min;
    const int count =
        dense_cull(C, bounds, meta, node_of, live, r, can_hit, tmax, s_list,
                   reinterpret_cast<unsigned*>(s_list + C), sh);
    if (threadIdx.x == 0) counts[blockIdx.x] = count;
}

// K9, the dense-cull closest hit (trace_bvh.py trace_closest_bvh_dense
// :1144, _closest_body(dense=True), _make_descent_dense :370): K10's
// steps 1 and 2, then K10's walk with the closest-hit leaf test
// (dense_walk<false>): each warp walks the list in id order; the lanes
// whose retest of the cluster's leaf box enters before their own best t
// are its owners, and the whole warp tests each owner's ray against the
// cluster's 128 triangles (warp_leaf<false> keeps the lowest j among
// equal t). An owner's hit lies below its best, so it always takes
// it, and a later cluster's equal t never replaces it: with the list in
// id order each ray keeps the lowest tri among exact t ties, the rows of
// a loop over the list and the 128 lanes with a strict t < best. JAX
// pops the clusters nearest first and stops once the nearest entry
// lies beyond every ray's best t; the id order tests more clusters and
// finds the same hit. What bounds it: the owners' tests (FP32 work, each
// IEEE division with its branch) and the cull. Output: K2's (R, 8) rows,
// a miss has t = t_max and tri = -1.
__global__ void __launch_bounds__(DENSE_TILE)
dense_closest_kernel(const float* __restrict__ slabs, int rows, int C,
                     const float* __restrict__ bounds,
                     const int* __restrict__ meta,
                     const int* __restrict__ node_of,
                     const uint8_t* __restrict__ live,
                     const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d,
                     const float* __restrict__ t_max, int R, float t_min,
                     float* __restrict__ out) {
    extern __shared__ int s_list[];  // C, then the bitmap
    __shared__ DenseShared sh;
    const int k = blockIdx.x * DENSE_TILE + threadIdx.x;
    const bool active = k < R;
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float tmax = 0.0f;
    if (active) {
        load_ray(ray_o, ray_d, k, r);
        tmax = t_max[k];
    }
    const bool can_hit = active && tmax > t_min;
    const int count =
        dense_cull(C, bounds, meta, node_of, live, r, can_hit, tmax, s_list,
                   reinterpret_cast<unsigned*>(s_list + C), sh);

    Hit h = {tmax, 0.0f, 0.0f, -1};
    dense_walk<false>(slabs, rows, bounds, node_of, s_list, count, r,
                      can_hit, t_min, h);
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
// against 128 rays in one (8, 128) op and sort key frames; here each lane
// walks its own ray's interior nodes (expand8): it loads a node's 8 slots
// (256 B, as float4s), slab-tests each against its current best, skips an
// empty slot by its NaN (fminf and fmaxf return the non-NaN operand, so an
// empty slot's entry is 0, as a box the ray starts in; only its NaN exit
// keeps the slab test from entering it, and the walk would re-enter the
// root at enc 0), for the closest walks orders the entered children
// near-first with a 19-comparator network in registers, and pushes them
// farthest first (the any-hit walk in slot order), on a stack of
// STACK8_CAP entries in local memory (1 KB a lane).
//
// K11-K13 (warp_walk8) test leaves as K1-K4 do: a lane walks until it
// pops a leaf and holds it; when every lane holds one or is done, the warp
// tests the pending leaves one owner at a time, all 32 lanes on each, 4
// triangles a lane on full 128-byte slab lines (leaf_round). K11's and
// K12's rows keep the lexicographic minimum of (t, tri) over every entered
// leaf box, the plain brute force's whatever the visit order: a box whose
// entry equals a best t that is a hit is still entered (enters8), and the
// leaf test runs under the (t, tri) rule (warp_leaf<false, true>) where K2
// lets the first visited cluster keep a tie. K13 tests with K3's any-hit
// test (warp_leaf<true>, t_min < t < t_max) and prunes at t_max alone,
// since its best never shrinks, and pushes a node's entered children in
// slot order; an occluded lane empties its stack. A lane holds its popped
// leaf until the warp has tested it, so its pops, prunes and tests are
// those of its own walk. What bounds them now: the lanes' interior steps
// (16 scattered float4 loads a node, K11's and K12's sort, the
// local-memory stack) and the leaf tests' FP32 work.
#define STACK8_CAP 128  // >= 7 * (8-wide depth) + 1 (trace_bvh.STACK8_CAP)
#define NO_CHILD (-2147483647 - 1)

// Whether an entry en passes the prune: below the best t, or for the
// closest walks equal to a best t that is a hit (it may still win a tie).
template <bool ANY>
__device__ __forceinline__ bool enters8(float en, const Hit& h) {
    return en < h.t || (!ANY && h.tri >= 0 && en == h.t);
}

// Slab test of one slot (a = min.xyz | max.x, b = max.yz | enc | 0)
// against the ray's best: node_test's arithmetic, with enters8's prune.
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
    return en <= ex && enters8<ANY>(en, h);
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

// One interior step of the 8-wide walks: tests node enc's 8 slots against
// the ray's best and pushes the entered children, the closest walks
// farthest first, so the nearest pops next. The any-hit walk (ANY) pushes
// them in slot order: any occluder ends it and its prune is t_max alone,
// so the order changes no result, and slot order measured 6% faster than
// near-first order on an H100 (PERF.md, K13). Returns false on stack
// overflow.
template <bool ANY>
__device__ __forceinline__ bool expand8(const float4* __restrict__ nodes8,
                                        int enc, const Ray& r, const Hit& h,
                                        int* stack_enc, float* stack_enter,
                                        int& sp) {
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
    if (n == 0) return true;
    if (sp + n > STACK8_CAP) return false;
    if (!ANY) {  // near first: ascending entry t
        CE(0, 2) CE(1, 3) CE(4, 6) CE(5, 7)
        CE(0, 4) CE(1, 5) CE(2, 6) CE(3, 7)
        CE(0, 1) CE(2, 3) CE(4, 5) CE(6, 7)
        CE(2, 4) CE(3, 5)
        CE(1, 4) CE(3, 6)
        CE(1, 2) CE(3, 4) CE(5, 6)
    }
    // push the last first, so the nearest (ANY: slot 0's) pops next
#pragma unroll
    for (int c = 7; c >= 0; --c) {
        if (val[c] != NO_CHILD) {
            stack_enc[sp] = val[c];
            stack_enter[sp] = key[c];
            ++sp;
        }
    }
    return true;
}
#undef CE

// One lane's 8-wide walk up to its next leaf: pops, prunes an entry by
// enters8<ANY>, expands an interior node (expand8<ANY>), until it pops a
// leaf, whose cluster it returns, or its stack is empty (-1). On stack
// overflow sets ok = false and empties the stack.
template <bool ANY>
__device__ __forceinline__ int next_leaf8(const float4* __restrict__ nodes8,
                                          const Ray& r, const Hit& h,
                                          int* stack_enc, float* stack_enter,
                                          int& sp, bool& ok) {
    while (sp > 0) {
        --sp;
        const int enc = stack_enc[sp];
        if (!enters8<ANY>(stack_enter[sp], h)) continue;
        if (enc < 0) return -enc - 1;
        if (!expand8<ANY>(nodes8, enc, r, h, stack_enc, stack_enter, sp)) {
            ok = false;
            sp = 0;
            return -1;
        }
    }
    return -1;
}

// The 8-wide walks: next_leaf8 per lane, the leaf tests by the whole
// warp (leaf_round). K11 and K12 (ANY = false) under the (t, tri) rule
// (warp_leaf<false, true>); K13 (ANY = true) with K3's any-hit test
// (warp_leaf<true>): an owner with a hit sets h.tri and its stack is
// emptied, so it pops nothing more while the warp finishes the others.
// Every thread of the warp calls it, a lane without a ray with h.t = 0
// (it never enters the root), and stays to the end: each _sync takes the
// full mask. Sets *err on stack overflow.
template <bool ANY>
__device__ void warp_walk8(const float* __restrict__ slabs, int rows,
                           const float4* __restrict__ nodes8, const Ray& r,
                           float t_min, Hit& h, int* __restrict__ err) {
    int stack_enc[STACK8_CAP];
    float stack_enter[STACK8_CAP];
    stack_enc[0] = 0;  // the root node: its slots carry the boxes
    stack_enter[0] = 0.0f;
    int sp = h.t > 0.0f ? 1 : 0;
    bool ok = true;
    for (;;) {
        const int leaf =
            next_leaf8<ANY>(nodes8, r, h, stack_enc, stack_enter, sp, ok);
        if (!leaf_round<ANY, !ANY, false>(slabs, rows, leaf, r, t_min, h, sp,
                                          nullptr))
            break;
    }
    if (!ok) atomicExch(err, 1);
}

// K11: (R, 8) rows t | tri | u | v | pad; a miss has t = t_max, tri = -1.
// A lane past R (h.t = 0) only takes part in the walk.
__global__ void closest8_kernel(const float* __restrict__ slabs, int rows,
                                const float4* __restrict__ nodes8,
                                const float* __restrict__ ray_o,
                                const float* __restrict__ ray_d,
                                const float* __restrict__ t_max, int R,
                                float t_min, float* __restrict__ out,
                                int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk8<false>(slabs, rows, nodes8, r, t_min, h, err);
    if (k >= R) return;
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
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk8<false>(slabs, rows, nodes8, r, t_min, h, err);
    if (k < R)
        write_full(slabs, rows, h.t, h.tri, h.u, h.v, out + 16 * (size_t)k);
}

// K13: (R,) occlusion, a hit being t_min < t < t_max. A lane past R
// (h.t = 0) only takes part in the walk.
__global__ void any8_kernel(const float* __restrict__ slabs, int rows,
                            const float4* __restrict__ nodes8,
                            const float* __restrict__ ray_o,
                            const float* __restrict__ ray_d,
                            const float* __restrict__ t_max, int R,
                            float t_min, uint8_t* __restrict__ occ,
                            int* __restrict__ err) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    Ray r;
    Hit h;
    load_lane(ray_o, ray_d, t_max, R, k, r, h);
    warp_walk8<true>(slabs, rows, nodes8, r, t_min, h, err);
    if (k < R) occ[k] = h.tri >= 0 ? 1 : 0;
}

inline int blocks(int n) { return (n + BLOCK - 1) / BLOCK; }

// Dynamic shared memory of a dense kernel: the list, one int a cluster,
// and the bitmap of entered clusters.
template <typename Kernel>
inline int dense_smem(Kernel kernel, int C, size_t& bytes) {
    bytes = sizeof(int) * ((size_t)C + (size_t)((C + 31) / 32));
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
        warp_closest_kernel<false>
            <<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
                slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, out,
                err);
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
        warp_closest_kernel<true>
            <<<blocks(R), BLOCK, 0, (cudaStream_t)stream>>>(
                slabs, rows, bounds, meta, ray_o, ray_d, t_max, R, t_min, out,
                err);
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

// K10 takes no overflow flag: its cull lists every live cluster when a
// warp's node stack would overflow. The list's shared memory is checked
// by the host against a block's 227 KB.
extern "C" int trace_any_bvh_dense(const float* slabs, int rows, int C,
                                   const float* bounds, const int* meta,
                                   const int* node_of,
                                   const uint8_t* live, const float* ray_o,
                                   const float* ray_d, const float* t_max,
                                   int R, float t_min, uint8_t* occ,
                                   void* stream) {
    if (R <= 0) return 0;
    size_t bytes;
    int e = dense_smem(dense_any_kernel, C, bytes);
    if (e != 0) return e;
    dense_any_kernel<<<(R + DENSE_TILE - 1) / DENSE_TILE, DENSE_TILE, bytes,
                       (cudaStream_t)stream>>>(slabs, rows, C, bounds, meta,
                                               node_of, live, ray_o, ray_d,
                                               t_max, R, t_min, occ);
    return (int)cudaGetLastError();
}

// The measurement form of K10's cull: counts (ceil(R / 128),) i32, the
// list length of each packet; slabs and rows are not read.
extern "C" int dense_cull_counts(int C, const float* bounds,
                                 const int* meta, const int* node_of,
                                 const uint8_t* live,
                                 const float* ray_o, const float* ray_d,
                                 const float* t_max, int R, float t_min,
                                 int* counts, void* stream) {
    if (R <= 0) return 0;
    size_t bytes;
    int e = dense_smem(dense_cull_kernel, C, bytes);
    if (e != 0) return e;
    dense_cull_kernel<<<(R + DENSE_TILE - 1) / DENSE_TILE, DENSE_TILE, bytes,
                        (cudaStream_t)stream>>>(C, bounds, meta, node_of,
                                                live, ray_o, ray_d, t_max, R,
                                                t_min, counts);
    return (int)cudaGetLastError();
}

// K9: as K10, with (R, 8) closest-hit rows.
extern "C" int trace_closest_bvh_dense(const float* slabs, int rows, int C,
                                       const float* bounds, const int* meta,
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
        slabs, rows, C, bounds, meta, node_of, live, ray_o, ray_d, t_max, R,
        t_min, out);
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
