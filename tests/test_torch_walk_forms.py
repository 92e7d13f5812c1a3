"""The measurement forms of K5 and K10 as their plain versions on the CPU,
and K9's walk counts.

- `shade_tiles.shade_walk_counts` (K5's walk without the shading): on a
  hand-built G-buffer whose warps straddle two z-slices, lanes reach
  their 128th visible light at different list entries, so the count of
  shaded lights, the entries each warp walks before the warp exit and
  the warp's shading union (the entries at which some lane shades) are
  known by hand. Exact.
- `trace_bvh.dense_cull_counts` (K10's cull alone): per 128-ray packet
  the number of live clusters whose leaf box some live ray enters,
  against a loop over rays and clusters in numpy float32 with the slab
  test's operations in the kernel's order. Exact.
- `trace_bvh.dense_walk_counts` (plain PyTorch: the clusters K9's walk
  tests per ray and per warp): against a walk of each ray's clusters in
  id order, best t lowered only by the clusters it owns. Exact.
"""

import numpy as np
import pytest
import torch

from prosper_tpu_torch import testing as ttesting
from prosper_tpu_torch.ops import shade_tiles as tst
from prosper_tpu_torch.ops import trace_bvh as tb
from prosper_tpu_torch.scene.convert import from_numpy_scene

torch.set_num_threads(2)

NEAR, FAR = 0.1, 100.0
# view depths in Doom slices 5 and 8 of [0.1, 100] (17 slices): slice 5
# spans [0.763, 1.145], slice 8 [2.581, 3.874]
Z_A, Z_B = 0.95, 3.2
N_LIGHTS = 300


def _two_slice_case(width=40, height=3):
    """G-buffer rows: 0, pixels x < 16 and x >= 32 at depth Z_A, the
    others at Z_B; 1, no surface; 2, all at Z_A. Light i sits at depth
    Z_A (even i) or Z_B (odd i) with radius 0.1, so only its own slice
    sees it; every tile lists all N_LIGHTS in ascending order."""
    R = width * height
    x = np.tile(np.arange(width), height)
    y = np.repeat(np.arange(height), width)
    depth = np.where((y == 0) & (x >= 16) & (x < 32), Z_B, Z_A)
    valid = y != 1
    chan = np.zeros((13, R), np.float32)
    chan[2] = -depth            # position on the view axis
    chan[5] = 1.0               # normal
    chan[6:9] = 0.5             # albedo
    chan[9] = 0.5               # roughness
    chan[11] = -depth           # view-space z
    chan[12] = valid
    lz = np.where(np.arange(N_LIGHTS) % 2 == 0, Z_A, Z_B).astype(np.float32)
    rows = np.zeros((1 + N_LIGHTS, 12), np.float32)
    rows[1:, 1:4] = 1.0
    rows[1:, 6] = -lz
    rows[1:, 7] = 0.1
    fx, fy = tst.tile_grid(width, height)
    lcap = -(-N_LIGHTS // 128) * 128
    lists = np.zeros((fx * fy, lcap), np.int32)
    lists[:, :N_LIGHTS] = np.arange(N_LIGHTS)
    lvz = np.zeros(lcap, np.float32)
    lvz[:N_LIGHTS] = -lz
    scal = np.array([NEAR, FAR, np.log(FAR / NEAR), 0, 0, 0, 0, 0],
                    np.float32)
    inp = {"chan": chan, "rows": rows, "lists": lists,
           "counts": np.full(fx * fy, N_LIGHTS, np.int32), "lvz": lvz,
           "ints": np.array([N_LIGHTS, 0], np.int32), "scal": scal}
    return {k: torch.as_tensor(v) for k, v in inp.items()}, x, y, valid


def test_walk_counts_on_warps_that_straddle_two_slices():
    width, height = 40, 3
    inp, x, y, valid = _two_slice_case(width, height)
    got = tst.shade_walk_counts(inp, width, height).numpy()
    # the 128th visible light: entry 254 at Z_A (even entries), 255 at
    # Z_B (odd entries)
    shaded = np.where(valid, 128, 0)
    straddle = (y == 0) & (x < 32)  # the warp of lanes at both depths
    walked = np.where(straddle, 256, np.where(valid, 255, 0))
    # the union: even entries 0-254 (128) for one depth, 0-255 (256) for
    # the warp whose lanes shade the even and the odd entries
    union = np.where(straddle, 256, np.where(valid, 128, 0))
    np.testing.assert_array_equal(got[:, 0], shaded)
    np.testing.assert_array_equal(got[:, 1], walked)
    np.testing.assert_array_equal(got[:, 2], union)
    assert torch.equal(torch.as_tensor(got),
                       tst.shade_walk_counts_plain(inp, width, height))


def test_walk_counts_agree_with_the_shading_counts():
    """On the same inputs the walk form's shaded count is the colour
    path's capped running count, and a warp walks the most `needed` of
    its lanes with a surface."""
    width, height = 40, 3
    inp, x, y, valid = _two_slice_case(width, height)
    _, cnt, needed = tst.shade_clustered_tiles_plain(inp, width, height,
                                                     return_counts=True)
    walk = tst.shade_walk_counts_plain(inp, width, height)
    v = torch.as_tensor(valid)
    assert torch.equal(walk[v, 0], torch.clamp_max(cnt, 128)[v])
    warp = torch.as_tensor(y * 2 + x // 32)
    for w in torch.unique(warp):
        lanes = (warp == w) & v
        want = float(needed[lanes].max()) if lanes.any() else 0.0
        assert (walk[warp == w, 1] == want).all()


@pytest.fixture(scope="module")
def cull_case():
    static, frame, arena, _ = ttesting.make_plate_scene(64, 0)
    scene = from_numpy_scene(static, frame, arena, "cpu")
    rng = np.random.default_rng(9)
    lo = frame["wc_aabb_min_w"].min(0)
    hi = frame["wc_aabb_max_w"].max(0)
    R = 300  # two full packets and a short one
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rng.uniform(0.0, 4.0, R).astype(np.float32)
    t_max[::5] = 0.05  # at or below t_min: no part in the cull
    return scene, o, d, t_max


def _cull_counts_by_loop(bounds, node_of, o, d, t_min, t_max, live):
    inv = np.where(np.abs(d) > 1e-12,
                   np.float32(1.0) / np.where(d == 0, 1, d),
                   np.float32(1e30)).astype(np.float32)
    out = []
    for p0 in range(0, o.shape[0], 128):
        listed = set()
        for c in np.flatnonzero(live):
            b = bounds[node_of[c]]
            for k in range(p0, min(o.shape[0], p0 + 128)):
                if not t_max[k] > t_min:
                    continue
                t0 = (b[:3] - o[k]) * inv[k]
                t1 = (b[3:] - o[k]) * inv[k]
                tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
                en = max(tn[0], tn[1], max(tn[2], np.float32(0.0)))
                ex = min(tf[0], tf[1], tf[2])
                if en <= ex and en < t_max[k]:
                    listed.add(c)
                    break
        out.append(len(listed))
    return np.array(out, np.int32)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "skip_mask"])
def test_cull_counts_match_a_loop_over_rays(cull_case, masked):
    scene, o, d, t_max = cull_case
    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]
    C = slabs.shape[0]
    mask = None
    live = np.ones(C, bool)
    if masked:
        live = np.random.default_rng(2).random(C) > 0.4
        mask = torch.as_tensor(live)
    got = tb.dense_cull_counts(slabs, bounds, meta, torch.as_tensor(o),
                               torch.as_tensor(d), 0.1, torch.as_tensor(t_max),
                               skip_mask=mask)
    node_of = tb.dense_aux(C, bounds, meta)[0].numpy()
    want = _cull_counts_by_loop(bounds.numpy(), node_of, o, d, 0.1, t_max,
                                live)
    assert got.dtype == torch.int32 and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all() and (want < live.sum()).any()
    # no live ray: nothing is listed
    none = tb.dense_cull_counts(slabs, bounds, meta, torch.as_tensor(o),
                                torch.as_tensor(d), 5.0,
                                torch.as_tensor(t_max), skip_mask=mask)
    assert (none == 0).all()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "skip_mask"])
def test_dense_walk_counts_match_a_walk_in_id_order(cull_case, masked):
    """`trace_bvh.dense_walk_counts` (what K9's walk tests) against a
    loop over each ray's live clusters in id order: the ray owns a
    cluster whose leaf box it enters before its best t so far, and only
    an owned cluster's nearest hit (the plain closest hit over that one
    cluster) lowers the best; a warp enters the clusters some lane owns.
    Exact."""
    scene, o, d, t_max = cull_case
    frame, slabs = scene["frame"], scene["geom"]["packed9"]
    bounds, meta = frame["bvh_bounds"], frame["bvh_meta"]
    C, R = slabs.shape[0], o.shape[0]
    live = np.ones(C, bool)
    if masked:
        live = np.random.default_rng(4).random(C) > 0.4
    args = (slabs, bounds, meta, torch.as_tensor(o), torch.as_tensor(d),
            0.1, torch.as_tensor(t_max))
    calls = tb.dense_walk_counts.calls
    owned, entered = tb.dense_walk_counts(
        *args, skip_mask=torch.as_tensor(live) if masked else None)
    assert tb.dense_walk_counts.calls == calls + 1
    near = np.full((R, C), np.inf, np.float32)
    for c in np.flatnonzero(live):
        only = torch.zeros(C, dtype=torch.bool)
        only[c] = True
        rows = tb.trace_closest_bvh_dense_plain(*args, skip_mask=only)
        hit = rows[:, 1].numpy() >= 0
        near[hit, c] = rows[hit, 0].numpy()
    _, cmin, cmax, _ = tb.dense_aux(C, bounds, meta)
    inv = tb.safe_inv_dir(torch.as_tensor(d))
    enter, exit_ = tb.slab_enter_exit(torch.as_tensor(o)[:, None],
                                      inv[:, None], cmin[None], cmax[None])
    enter, exit_ = enter.numpy(), exit_.numpy()
    want = np.zeros((R, C), bool)
    for k in range(R):
        if not t_max[k] > 0.1:
            continue
        best = t_max[k]
        for c in np.flatnonzero(live):
            if enter[k, c] <= exit_[k, c] and enter[k, c] < best:
                want[k, c] = True
                best = min(best, near[k, c])
    pad = np.zeros((-R % 32, C), bool)
    by_warp = np.concatenate([want, pad]).reshape(-1, 32, C).any(axis=1)
    assert owned.dtype == entered.dtype == torch.int32
    np.testing.assert_array_equal(owned.numpy(), want.sum(1))
    np.testing.assert_array_equal(entered.numpy(), by_warp.sum(1))
    assert entered.shape == (10,) and 0 < owned.sum() < want.size
    assert (owned.numpy() < (enter <= exit_).sum(1)).any()
