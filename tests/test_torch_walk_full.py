"""The lockstep plain walk under a cluster skip mask: the one-thread walk
that K1 and K4 (csrc/trace_bvh.cu warp_walk) must reproduce bit for bit,
with attributes through _full_rows, on the CPU.

- testing.make_tie_scene with attribute rows: exact t ties, where a
  walk keeps the lowest lane of the cluster it visits first; a mask
  that kills a cluster hands its rays the other cluster's lowest copy.
  Exact: tri ids, t, u, v and the attributes bit for bit.
- plate-64: the masked walk + _full_rows against K4's plain version
  (brute force over the live clusters) and against the JAX package's
  trace_closest_bvh_full with the same skip_mask, run in Pallas
  interpret mode (tests/test_torch_deferred_kernels.py's rays and
  tolerances: tri equal but exact t ties, t within rtol 1e-5,
  attributes within 1e-4; JAX's kernel hard-codes t_min 1e-4, which
  the port is given)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops import trace_bvh as jtb
from prosper_tpu_torch.ops import trace_bvh as tb
from prosper_tpu_torch.testing import (
    CLUSTER_TRI_PAD,
    TIE_LANES,
    make_tie_scene,
)
from tests.test_torch_deferred_kernels import _plate_rays
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)

N_RAYS = 64
UP_COPY = CLUSTER_TRI_PAD + TIE_LANES[1][0]  # cluster 1's lowest copy
DOWN_COPY = TIE_LANES[0][0]  # cluster 0's


def _tie_case(seed=4):
    slabs, bounds, meta, o, d, want = (
        torch.as_tensor(a) for a in make_tie_scene(N_RAYS, seed, rows=40))
    return (slabs, bounds, meta, o, d), want


def _walk_full(slabs, bounds, meta, o, d, t_min, t_max, mask=None):
    rows = tb.trace_closest_bvh_visits_plain(slabs, bounds, meta, o, d,
                                             t_min, t_max, skip_mask=mask)
    return rows, tb._full_rows(slabs, rows)


def test_tie_scene_attribute_rows():
    """rows=40 keeps the geometry and rays of the 9-row scene and gives
    every lane its own attribute row."""
    plain = make_tie_scene(N_RAYS, 4)
    full = make_tie_scene(N_RAYS, 4, rows=40)
    assert full[0].shape == (2, 40, CLUSTER_TRI_PAD)
    np.testing.assert_array_equal(full[0][:, 0:9], plain[0])
    for a, b in zip(full[1:], plain[1:]):
        np.testing.assert_array_equal(a, b)
    attrs = full[0][:, 9:].transpose(0, 2, 1).reshape(-1, 31)
    assert len(np.unique(attrs, axis=0)) == 2 * CLUSTER_TRI_PAD


# which cluster the mask keeps -> (up rays' tri, down rays' tri, leaves
# an up ray tests, leaves a down ray tests)
TIE_MASKS = {
    "none": (None, UP_COPY, DOWN_COPY, 2, 2),
    "kill_1": ((True, False), DOWN_COPY, DOWN_COPY, 1, 1),
    "kill_0": ((False, True), UP_COPY, UP_COPY, 1, 1),
    "kill_both": ((False, False), -1, -1, 0, 0),
}


@pytest.mark.parametrize("case", sorted(TIE_MASKS))
def test_masked_walk_keeps_the_lowest_lane_on_ties(case):
    """A dead cluster is dropped on pop, before it is tested or counted:
    with cluster 1 killed the up rays take cluster 0's lowest copy. The
    full rows are the chosen copy's attributes at the tie's u, v,
    exactly."""
    live, up_tri, down_tri, up_leaves, down_leaves = TIE_MASKS[case]
    (slabs, bounds, meta, o, d), _ = _tie_case()
    mask = None if live is None else torch.tensor(live)
    inf = torch.full((N_RAYS,), float("inf"))
    rows, full = _walk_full(slabs, bounds, meta, o, d, 1e-4, inf, mask)
    up = torch.arange(N_RAYS) % 2 == 0
    want_tri = torch.where(up, up_tri, down_tri)
    assert torch.equal(full[:, 1].long(), want_tri)
    assert torch.equal(rows[:, 7], torch.where(up, up_leaves, down_leaves)
                       .to(torch.float32))
    assert torch.equal(full[:, 0:2], rows[:, 0:2])
    hit = want_tri >= 0
    if not hit.any():
        assert (full[:, 0] == float("inf")).all() and not full[:, 2:].any()
        return
    assert (rows[hit, 0] == rows[0, 0]).all()
    # the same t, u, v on the lowest copy of each cluster give the same
    # rows but for the attributes of the copy's own lane
    ref = rows.clone()
    ref[:, 1] = want_tri.to(torch.float32)
    assert torch.equal(full, tb._full_rows(slabs, ref))
    if up_tri != down_tri:
        assert not torch.equal(full[up][0, 2:13], full[~up][0, 2:13])
    # the brute force keeps the lowest tri; with one live cluster the two
    # agree to the bit
    plain = tb.trace_closest_bvh_full_plain(slabs, bounds, meta, o, d, 1e-4,
                                            inf, skip_mask=mask)
    if up_tri == down_tri:
        assert torch.equal(plain, full)
    else:
        assert (plain[:, 1] == DOWN_COPY).all()


def test_walk_with_every_cluster_live_is_the_unmasked_walk():
    scene, frame, o, d, t_max, _ = _plate_rays(n_clusters=64, seed=6, R=256)
    args = (scene["geom"]["packed_full"], torch.as_tensor(frame["bvh_bounds"]),
            torch.as_tensor(frame["bvh_meta"]), torch.as_tensor(o),
            torch.as_tensor(d), 1e-4, torch.as_tensor(t_max))
    every = torch.ones(64, dtype=torch.bool)
    assert torch.equal(tb.trace_closest_bvh_visits_plain(*args),
                       tb.trace_closest_bvh_visits_plain(*args,
                                                         skip_mask=every))


def _plate_case(seed, masked):
    scene, frame, o, d, t_max, mask = _plate_rays(n_clusters=64, seed=seed,
                                                  R=512)
    args = (scene["geom"]["packed_full"], torch.as_tensor(frame["bvh_bounds"]),
            torch.as_tensor(frame["bvh_meta"]), torch.as_tensor(o),
            torch.as_tensor(d), 1e-4, torch.as_tensor(t_max))
    return args, (torch.as_tensor(mask) if masked else None)


def _assert_full_rows(got, want, min_hits=0.1):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(got[:, 1] >= 0, want[:, 1] >= 0)
    both = want[:, 1] >= 0
    assert both.mean() > min_hits and not both.all()
    with np.errstate(invalid="ignore"):  # inf - inf on misses
        tie = np.abs(got[:, 0] - want[:, 0]) <= 1e-6 * np.abs(want[:, 0])
    assert ((got[:, 1] == want[:, 1]) | tie)[both].all()
    np.testing.assert_allclose(got[both, 0], want[both, 0], rtol=1e-5,
                               atol=1e-6)
    same = both & (got[:, 1] == want[:, 1])
    np.testing.assert_allclose(got[same, 2:13], want[same, 2:13], atol=1e-4)


@pytest.mark.parametrize("seed,masked", [(2, True), (3, True), (4, False)])
def test_masked_walk_matches_full_plain_on_plate(seed, masked):
    """The masked walk + _full_rows against trace_closest_bvh_full_plain
    with the same mask; no hit on a masked cluster."""
    args, mask = _plate_case(seed, masked)
    _, full = _walk_full(*args, mask)
    _assert_full_rows(full, tb.trace_closest_bvh_full_plain(
        *args, skip_mask=mask))
    if mask is not None:
        tri = full[:, 1].long()
        assert mask[tri[tri >= 0] // CLUSTER_TRI_PAD].all()
        # the mask drops clusters the unmasked walk hits
        _, unmasked = _walk_full(*args)
        tri = unmasked[:, 1].long()
        assert not mask[tri[tri >= 0] // CLUSTER_TRI_PAD].all()


@pytest.mark.parametrize("seed", [2, 5])
def test_masked_walk_matches_pallas(seed):
    """The masked walk + _full_rows against JAX's trace_closest_bvh_full
    with the same skip_mask, in Pallas interpret mode."""
    args, mask = _plate_case(seed, True)
    slabs, bounds, meta, o, d, t_min, t_max = args
    with interpret_mode():
        want = np.asarray(jtb.trace_closest_bvh_full(
            jnp.asarray(slabs.numpy()), jnp.asarray(bounds.numpy()),
            jnp.asarray(meta.numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()), t_min, jnp.asarray(t_max.numpy()),
            packed=True, skip_mask=jnp.asarray(mask.numpy())))
    _, full = _walk_full(*args, mask)
    _assert_full_rows(full, torch.from_numpy(want.copy()))
