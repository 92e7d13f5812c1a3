"""What the CPU can check of the trace kernels without building them.

- Every `extern "C"` entry point of a CUDA source under
  prosper_tpu_torch/csrc has an argument table in its wrapper module of
  the same arity and kinds (pointer, int, float; the stream, which
  cuda_build.launch appends, aside), and every table entry names an
  entry point. ctypes passes what the table says, so a table that lags
  its source would cut a pointer or shift every later argument. The
  measurement forms of K5 and K10 (shade_walk_counts, dense_cull_counts)
  have entry points and launch counts of their own.
- The ReSTIR wrappers' dispatch (spatial reuse, initial neighbour
  rows): their plain twins on CPU tensors, the kernels' checks (which
  refuse what is not CUDA) elsewhere.
- The visit order the closest-hit kernels keep on exact t ties, on
  testing.make_tie_scene: the lockstep plain walk (trace_bvh's
  trace_closest_bvh_visits_plain, each ray's own walk, which K2's and
  X3a's warp-shared leaf tests must reproduce) keeps the lowest lane of
  a cluster and, across clusters, the one it visits first. Exact: tri ids, t, u, v bit for bit."""

import ctypes
import re

import numpy as np
import pytest
import torch

from prosper_tpu_torch.experiments import trace_wavefront as tw
from prosper_tpu_torch.ops import bench_kernels as bk
from prosper_tpu_torch.ops import shade_tiles as tst
from prosper_tpu_torch.ops import trace_bvh as tb
from prosper_tpu_torch.ops import trace_flat as tf
from prosper_tpu_torch.ops import trace_leafmajor as lm
from prosper_tpu_torch.ops.cuda_build import CSRC, SOURCES
from prosper_tpu_torch.render import restir
from prosper_tpu_torch.render.shading import sample_light_packed
from prosper_tpu_torch.testing import (
    CLUSTER_TRI_PAD,
    TIE_LANES,
    as_spot_rows,
    make_plate_scene,
    make_tie_scene,
)

torch.set_num_threads(2)

# source -> {entry point: the argument types its wrapper passes}
TABLES = {
    "trace_bvh": tb._ARGTYPES,
    "shade_tiles": {name: tst._ARGTYPES for name in (
        "shade_clustered_tiles", "shade_walk_counts")},
    "trace_flat": {name: tf._ARGTYPES for name in (
        "trace_closest_flat", "trace_closest_flat_full", "trace_any_flat")},
    "trace_leafmajor": {"run_pairs": lm._ARGTYPES},
    "trace_wavefront": {"walk_leaves": tw._ARGTYPES},
    "bench_kernels": {"isect_loop": bk._ISECT_ARGS, **bk._PROBE_ARGS},
    "restir_spatial": {"spatial_reuse": restir._ARGTYPES},
    "restir_initial": {"ris_initial": restir._INITIAL_ARGTYPES},
}
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _kind(param: str):
    """The ctypes type a C parameter takes: pointers as c_void_p."""
    if "*" in param:
        return ctypes.c_void_p
    ctype = param.replace("const", "").split()[0]
    return {"int": ctypes.c_int, "unsigned": ctypes.c_uint32,
            "float": ctypes.c_float}[ctype]


def _entry_points(source: str) -> dict:
    """{name: [ctypes kinds of the parameters before the stream]} of the
    extern "C" functions of csrc/<source>.cu."""
    text = (CSRC / f"{source}.cu").read_text()
    out = {}
    for name, params in ENTRY.findall(text):
        params = [p.strip() for p in params.split(",")]
        assert params[-1] == "void* stream", (name, params[-1])
        out[name] = [_kind(p) for p in params[:-1]]
    return out


def test_tables_cover_every_source():
    assert sorted(TABLES) == sorted(SOURCES)
    assert all((CSRC / f"{s}.cu").exists() for s in SOURCES)


@pytest.mark.parametrize("source", sorted(TABLES))
def test_argument_tables_match_entry_points(source):
    entries = _entry_points(source)
    table = TABLES[source]
    assert entries, source
    assert sorted(table) == sorted(entries)
    for name, kinds in entries.items():
        assert len(table[name]) == len(kinds), name
        assert list(table[name]) == kinds, name


# the measurement forms, which chip_smoke.py alone calls: source ->
# (entry point, its wrapper)
MEASUREMENT_FORMS = {
    "shade_tiles": ("shade_walk_counts", tst.shade_walk_counts),
    "trace_bvh": ("dense_cull_counts", tb.dense_cull_counts),
}


@pytest.mark.parametrize("source", sorted(MEASUREMENT_FORMS))
def test_measurement_forms_have_entry_points_and_counts(source):
    """Each measurement form has its own entry point, an argument table
    of its arity, and a launch count among its module's kernels (so a
    frame that launched it would show)."""
    name, wrapper = MEASUREMENT_FORMS[source]
    entries = _entry_points(source)
    assert name in entries and name in TABLES[source]
    assert list(TABLES[source][name]) == entries[name]
    assert wrapper.__name__ == name and isinstance(wrapper.launches, int)
    module = {"shade_tiles": tst, "trace_bvh": tb}[source]
    assert wrapper in module.KERNELS


def test_spatial_reuse_runs_its_twin_on_cpu_and_raises_elsewhere():
    """spatial_reuse takes its plain twin only for CPU tensors, without a
    launch; on any other device it goes to the kernel's checks, which
    refuse what is not CUDA (no fallback). Its launch count is among
    restir.KERNELS."""
    R, W = 12, 4
    gen = torch.Generator().manual_seed(5)

    def inputs(device):
        surface = {k: torch.rand((R, 3) if k.endswith(("_ws", "ray", "albedo"))
                                 else (R,), generator=gen).to(device)
                   for k in ("linear_depth", "normal_ws", "position_ws",
                             "inv_view_ray", "albedo", "roughness",
                             "metallic")}
        rows = torch.zeros((2, 12))
        rows[1, 0] = 1.0
        lights = {"packed_rows": rows.to(device)}
        neigh = torch.rand((R, 8), generator=gen).to(device)
        px = torch.arange(W).repeat(R // W).to(device)
        py = torch.arange(R // W).repeat_interleave(W).to(device)
        return surface, lights, neigh, px, py, W, R // W, 7

    assert restir.spatial_reuse in restir.KERNELS
    before = restir.spatial_reuse.launches
    args = inputs("cpu")
    got = restir.spatial_reuse(*args)
    want = restir.spatial_reuse_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert restir.spatial_reuse.launches == before
    with pytest.raises(ValueError, match="unsupported device meta"):
        restir.spatial_reuse(*inputs("meta"))
    assert restir.spatial_reuse.launches == before


def test_initial_neighbor_rows_runs_its_twin_on_cpu_and_raises_elsewhere():
    """initial_neighbor_rows takes its plain twin only for CPU tensors,
    without a launch: the rows of initial_reservoirs, the valid mask on
    the light index alone and pack_neighbor_rows, as render_restir
    composed them before the kernel; on any other device it goes to the
    kernel's checks, which refuse what is not CUDA (no fallback). Its
    launch count is among restir.KERNELS."""
    R, W = 12, 4
    gen = torch.Generator().manual_seed(6)

    def inputs(device):
        surface = {k: torch.rand((R, 3) if k.endswith(("_ws", "ray", "albedo"))
                                 else (R,), generator=gen).to(device)
                   for k in ("linear_depth", "normal_ws", "position_ws",
                             "inv_view_ray", "albedo", "roughness",
                             "metallic")}
        # the sun, a point light and a spot light, each counted
        rows = torch.zeros((3, 12))
        rows[0, 1:7] = torch.tensor([2.0, 2.0, 2.0, -1.0, -1.0, -1.0])
        rows[1, :8] = torch.tensor([1.0, 5.0, 5.0, 5.0, 0.5, 0.5, 2.0, 9.0])
        rows[2] = torch.tensor([2.0, 5.0, 5.0, 5.0, 0.5, 0.5, 2.0, 2.0,
                                0.0, 0.0, -1.0, -0.5])
        lights = {"packed_rows": rows.to(device),
                  "point_count": torch.tensor(1, dtype=torch.int32,
                                              device=device),
                  "spot_count": torch.tensor(1, dtype=torch.int32,
                                             device=device)}
        nm = torch.rand((R, 4), generator=gen).to(device)
        valid = (torch.arange(R) % 3 != 0).to(device)
        px = torch.arange(W).repeat(R // W).to(device)
        py = torch.arange(R // W).repeat_interleave(W).to(device)
        return surface, lights, nm, valid, px, py, 7

    assert restir.initial_neighbor_rows in restir.KERNELS
    before = restir.initial_neighbor_rows.launches
    args = inputs("cpu")
    surface, lights, nm, valid, px, py, frame = args
    got = restir.initial_neighbor_rows(*args)
    li, ucw = restir.initial_reservoirs(surface, lights, px, py, frame)
    assert bool((li >= 0).any())
    want = torch.cat([surface["linear_depth"][:, None], nm[:, :3],
                      torch.where(valid, li, -1).float()[:, None],
                      ucw[:, None], torch.zeros((R, 2))], dim=-1)
    assert got.shape == (R, 8) and torch.equal(got, want)
    assert torch.equal(got, restir.initial_neighbor_rows_plain(*args))
    assert restir.initial_neighbor_rows.launches == before
    with pytest.raises(ValueError, match="unsupported device meta"):
        restir.initial_neighbor_rows(*inputs("meta"))
    assert restir.initial_neighbor_rows.launches == before


def test_as_spot_rows_light_their_targets():
    """The spot rows the card tests give the spatial reuse kernel: the
    odd points of the plate scene's lights become spot lights that light
    their targets fully (irradiance = radiance / d^2) and nothing outside
    their outer cone; the sun and the even points stay."""
    _, frame, _, _ = make_plate_scene(16, 0, scatter_lights=9)
    rows = frame["lights"]["packed_rows"]
    targets = np.random.default_rng(1).uniform(-1.0, 1.0, (3, 3))
    out = as_spot_rows(rows, 9, targets)
    spots = np.arange(1, 10, 2)
    assert (out[spots, 0] == 2.0).all()
    keep = np.setdiff1d(np.arange(rows.shape[0]), spots)
    np.testing.assert_array_equal(out[keep], rows[keep])
    # every light keeps its radiance and position
    np.testing.assert_array_equal(out[:, 1:7], rows[:, 1:7])
    aim = targets[np.arange(5) % 3]
    axis = aim - rows[spots, 4:7]
    # the target, and a point behind the light: outside the cone
    for where, lit in ((aim, True), (rows[spots, 4:7] - axis, False)):
        _, _, irr = sample_light_packed(_t(out), _t(spots),
                                        _t(where.astype(np.float32)))
        d2 = ((where - rows[spots, 4:7]) ** 2).sum(-1, keepdims=True)
        want = rows[spots, 1:4] / d2 if lit else np.zeros((5, 3))
        np.testing.assert_allclose(irr.numpy(), want, rtol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tie_rows(n_rays, t_max, visits=True):
    slabs, bounds, meta, o, d, want = make_tie_scene(n_rays)
    args = (_t(slabs), _t(bounds), _t(meta), _t(o), _t(d), 1e-4, t_max)
    fn = (tb.trace_closest_bvh_visits_plain if visits
          else tb.trace_closest_bvh_plain)
    return fn(*args), want


@pytest.mark.parametrize("n_rays", [1, 31, 64])
def test_walk_keeps_lowest_lane_and_first_cluster_on_ties(n_rays):
    t_max = torch.full((n_rays,), float("inf"))
    rows, want = _tie_rows(n_rays, t_max)
    tri = rows[:, 1].long().numpy()
    np.testing.assert_array_equal(tri, want)
    # every copy ties: one t, and u, v of the one triangle
    assert torch.equal(rows[:, 0], rows[0:1, 0].expand(n_rays))
    assert abs(float(rows[0, 0]) - 5.0) <= 1e-5
    # both leaves are tested: the second visit sees the tie and keeps the
    # first cluster's copy
    assert (rows[:, 7] == 2).all() and (rows[:, 6] == 1).all()
    # the brute force keeps the lowest tri id instead, with equal t, u, v
    brute, _ = _tie_rows(n_rays, t_max, visits=False)
    assert (brute[:, 1] == TIE_LANES[0][0]).all()
    assert torch.equal(brute[:, [0, 2, 3]], rows[:, [0, 2, 3]])


def test_tie_scene_lanes_defeat_a_lane_minimum():
    """The copies are placed so that the lowest warp lane holding a copy
    is not the lowest copy (lane = tri % 32)."""
    for lanes in TIE_LANES:
        lowest = min(lanes)
        assert min(j % 32 for j in lanes) != lowest % 32
    assert CLUSTER_TRI_PAD == 128


def test_walk_wrapper_on_cpu_is_the_plain_walk_on_ties():
    """trace_closest_bvh_visits on CPU tensors runs the lockstep plain
    walk; t_max = 0 on every ninth ray gives a miss row that tests no
    node, t_max 4, below the tie's t, a miss row after the leaves the
    ray enters before 4: both for an up ray (entries 1 and 2), cluster
    0's for a down ray (entries 2 and 4)."""
    n = 40
    slabs, bounds, meta, o, d, want = make_tie_scene(n, seed=3)
    t_max = torch.full((n,), float("inf"))
    t_max[::9] = 0.0
    t_max[1::7] = 4.0
    args = (_t(slabs), _t(bounds), _t(meta), _t(o), _t(d), 1e-4)
    rows = tb.trace_closest_bvh_visits(*args, t_max)
    assert torch.equal(rows, tb.trace_closest_bvh_visits_plain(*args, t_max))
    dead, short = t_max == 0.0, t_max == 4.0
    assert (rows[dead, 1] == -1).all() and (rows[dead, 6:8] == 0).all()
    assert (rows[short, 1] == -1).all() and (rows[short, 0] == 4.0).all()
    up = torch.arange(n) % 2 == 0
    assert torch.equal(rows[short, 7], torch.where(up, 2.0, 1.0)[short])
    live = ~(dead | short)
    np.testing.assert_array_equal(rows[live, 1].long().numpy(), want[live])
