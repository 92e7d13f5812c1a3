"""What K6's and K8's warp walk must reproduce, on the CPU.

- The tie rule of the flat closest-hit kernels (ops/trace_flat.py): on
  testing.make_tie_scene every ray meets a copy of one triangle in
  cluster 0 (lowest copy tri 9) and in cluster 1 (lowest copy tri 168)
  at the same t. An up ray's tile lists cluster 1 first, yet the flat
  contract gives tri 9 to every ray, the lowest id over all clusters,
  where a walk that keeps the earlier visit (K2's, and the Pallas
  kernel's) gives 168. The plain versions, which the kernels must equal
  bit for bit, are held to that: tri 9 for the up rays alone, the down
  rays alone and a mixed tile, t, u, v those of the brute force over
  every cluster, and K8's attributes those of tri 9. Exact.
- A whole tile of up rays through prosper_tpu's trace_closest_pallas
  in interpret mode: the TPU kernel keeps the first listed copy (168) at
  the same t, u, v, an exact tie, which the kernel-against-Pallas
  tolerance of tests/test_torch_flat_kernels.py admits. Exact.
- `flat_walk_counts`, the measurement of the walk: per ray its tile's
  list length, the listed clusters it enters and those it enters no
  later than its final t, against a loop over tiles, rays and clusters
  in numpy float32 with the packet cull's and the slab test's operations
  in the kernels' order. Exact.
- The shared-memory limit of the cull list: K6, K8 and K7 hold the
  list and its chunk boxes alone, and refuse the first C whose list does
  not fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import trace_pallas
from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import trace_bvh as tb
from prosper_tpu_torch.ops import trace_flat as tf
from prosper_tpu_torch.render.gbuffer import _masked_aabbs
from prosper_tpu_torch.scene.convert import from_numpy_scene
from prosper_tpu_torch.testing import CLUSTER_TRI_PAD, TIE_LANES
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)

LOWEST = TIE_LANES[0][0]  # tri 9, cluster 0's lowest copy
FIRST_UP = CLUSTER_TRI_PAD + TIE_LANES[1][0]  # tri 168, listed first


def _tie_case(rays, rows, n_rays=64):
    """The tie scene's cluster boxes (the BVH's leaves) and the rays of
    one kind: "up" (even rays), "down" (odd rays) or "mixed" (all)."""
    slabs, bounds, meta, o, d, _ = ttesting.make_tie_scene(n_rays, rows=rows)
    pick = {"up": slice(0, None, 2), "down": slice(1, None, 2),
            "mixed": slice(None)}[rays]
    slabs, bounds, meta = (torch.as_tensor(a) for a in (slabs, bounds, meta))
    mn, mx = tb._leaf_boxes(bounds, meta, 2)
    return (slabs, mn, mx, torch.as_tensor(o[pick]),
            torch.as_tensor(d[pick]), bounds, meta)


@pytest.mark.parametrize("rows", [9, 40])
@pytest.mark.parametrize("rays", ["up", "down", "mixed"])
def test_flat_plain_gives_the_lowest_tri_on_ties(rays, rows):
    slabs, mn, mx, o, d, bounds, meta = _tie_case(rays, rows)
    R = o.shape[0]
    inf = torch.full((R,), float("inf"))
    lists, counts, _ = tf.cull_lists(o, d, 1e-4, inf, mn, mx)
    assert (counts == 2).all()
    if rays == "up":  # the walk meets cluster 1's copies first
        assert lists[0, 0] == 1
    got = tf.trace_closest_flat(slabs, mn, mx, o, d, 1e-4, inf)
    assert (got[:, 1] == LOWEST).all()
    # t, u, v of the brute force over every cluster, bit for bit
    brute = tb.trace_closest_bvh_plain(slabs, bounds, meta, o, d, 1e-4, inf)
    assert torch.equal(got, brute)
    assert torch.equal(got[:, 0], got[0:1, 0].expand(R))
    assert abs(float(got[0, 0]) - 5.0) <= 1e-5
    if rows < 38:
        return
    full = tf.trace_closest_flat_full(slabs, mn, mx, o, d, 1e-4, inf)
    assert torch.equal(full, tb._full_rows(slabs, got))
    # the attributes are tri 9's, not those of the copy listed first
    first = got.clone()
    first[:, 1] = FIRST_UP
    assert not torch.equal(full[:, 2:13], tb._full_rows(slabs, first)[:, 2:13])
    assert (tf.trace_closest_flat.launches,
            tf.trace_closest_flat_full.launches) == (0, 0)


def test_pallas_flat_keeps_the_first_listed_copy_on_ties():
    """A whole tile of up rays: the Pallas kernel pads a short tile with
    rays of its own, whose directions would widen the packet's."""
    slabs, mn, mx, o, d, _, _ = _tie_case("up", 9, n_rays=512)
    inf = torch.full((o.shape[0],), float("inf"))
    got = tf.trace_closest_flat(slabs, mn, mx, o, d, 1e-4, inf)
    with interpret_mode():
        want = trace_pallas.trace_closest_pallas(
            *(jnp.asarray(a.numpy()) for a in (slabs, mn, mx, o, d)), 1e-4,
            jnp.asarray(inf.numpy()))
    assert (np.asarray(want["tri"]) == FIRST_UP).all()
    for col, key in ((0, "t"), (2, "u"), (3, "v")):
        np.testing.assert_array_equal(got[:, col].numpy(),
                                      np.asarray(want[key]))


F32 = np.float32
BIG = F32(3e38)


def _packet_enter_exit(o, d, lo, hi):
    """ops/intersect.packet_aabb_enter_exit of one packet (rays o, d) and
    one box, in numpy float32 scalars."""
    enter, exit_ = -BIG, BIG
    for a in range(3):
        olo, ohi = o[:, a].min(), o[:, a].max()
        dlo, dhi = d[:, a].min(), d[:, a].max()
        if not (dlo > 0 or dhi < 0):
            continue
        ia, ib = F32(1) / dhi, F32(1) / dlo
        prods = [x * y for x in (lo[a] - ohi, lo[a] - olo,
                                 hi[a] - ohi, hi[a] - olo) for y in (ia, ib)]
        enter = max(enter, min(prods))
        exit_ = min(exit_, max(prods))
    if (lo > hi).any():
        return BIG, -BIG
    return enter, exit_


def _walk_counts_by_loop(mn, mx, o, d, t_min, t_max, t_hit):
    inv = np.where(np.abs(d) > 1e-12, F32(1) / np.where(d == 0, 1, d),
                   F32(1e30)).astype(F32)
    out = np.zeros((o.shape[0], 3), np.int32)
    for k0 in range(0, o.shape[0], 256):
        k1 = min(o.shape[0], k0 + 256)
        tile_tmax = t_max[k0:k1].max()
        listed = []
        for c in range(mn.shape[0]):
            en, ex = _packet_enter_exit(o[k0:k1], d[k0:k1], mn[c], mx[c])
            if (tile_tmax > t_min and en <= ex and ex >= 0
                    and en <= tile_tmax):
                listed.append(c)
        for k in range(k0, k1):
            out[k, 0] = len(listed)
            if not t_max[k] > t_min:
                continue
            for c in listed:
                t0 = (mn[c] - o[k]) * inv[k]
                t1 = (mx[c] - o[k]) * inv[k]
                tn, tx = np.minimum(t0, t1), np.maximum(t0, t1)
                en = max(max(tn[0], tn[1]), max(tn[2], F32(0)))
                ex = min(min(tx[0], tx[1]), tx[2])
                if en <= ex and en < t_max[k]:
                    out[k, 1] += 1
                    out[k, 2] += int(en <= t_hit[k])
    return out


@pytest.fixture(scope="module")
def walk_case():
    """plate-64 (blend and mask plates), 300 incoherent rays (two full
    tiles and a short one) from inside the scene's bounds, every fifth
    with t_max 0.05 <= t_min, a cluster mask."""
    static, frame, arena, _ = ttesting.make_plate_scene(
        64, 0, blend_every=8, mask_every=8)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(5)
    lo = frame["wc_aabb_min_w"].min(0)
    hi = frame["wc_aabb_max_w"].max(0)
    R = 300
    o = rng.uniform(lo, hi, (R, 3)).astype(F32)
    d = rng.normal(size=(R, 3)).astype(F32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    t_max = rng.uniform(0.5, 6.0, R).astype(F32)
    t_max[::5] = 0.05
    keep = torch.as_tensor(rng.random(64) > 0.3)
    return scene, o, d, t_max, keep


@pytest.mark.parametrize("boxes", ["all", "masked"])
def test_flat_walk_counts_match_a_loop(walk_case, boxes):
    scene, o, d, t_max, keep = walk_case
    mn, mx = scene["frame"]["wc_aabb_min_w"], scene["frame"]["wc_aabb_max_w"]
    if boxes == "masked":
        mn, mx = _masked_aabbs(mn, mx, keep)
    args = (mn, mx, torch.as_tensor(o), torch.as_tensor(d), 0.1,
            torch.as_tensor(t_max))
    rows = tf.trace_closest_flat(scene["geom"]["packed9"], *args[:4], 0.1,
                                 args[5])
    calls = tf.flat_walk_counts.calls
    got = tf.flat_walk_counts(*args, rows[:, 0])
    assert tf.flat_walk_counts.calls == calls + 1
    want = _walk_counts_by_loop(mn.numpy(), mx.numpy(), o, d, F32(0.1),
                                t_max, rows[:, 0].numpy())
    assert got.dtype == torch.int32 and got.shape == (300, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    listed, entered, needed = want.T
    assert (entered <= listed).all() and (needed <= entered).all()
    assert (entered[::5] == 0).all() and (entered > 0).any()
    assert (needed < entered).any()  # a hit ends some ray's walk early
    hit = rows[:, 1].numpy() >= 0
    assert hit.any() and (needed[hit] > 0).any()
    if boxes == "masked":  # a masked cluster is never listed
        assert (listed <= int(keep.sum())).all()
    # no live ray: every tile lists nothing
    none = tf.flat_walk_counts(*args[:4], 7.0, args[5], rows[:, 0])
    assert not none.any()


def test_list_limits_follow_the_shared_memory():
    """K6, K8 and K7 keep a (key, id) list of the next power of two above
    C entries and 6 floats of chunk box for every 32 of them, no staged
    slab; C = 16384 fits a block's shared memory, 16385 does not (the
    wrappers refuse it on the card)."""
    assert tf.list_bytes(2048) == 4 * (2 * 2048 + 6 * 64)
    assert tf.list_bytes(1) == 4 * (2 + 6)
    assert tf.list_bytes(16384) == 4 * (2 * 16384 + 6 * 512)
    assert tf.list_bytes(16384) <= tb.MAX_SHARED
    assert tf.list_bytes(16385) > tb.MAX_SHARED
