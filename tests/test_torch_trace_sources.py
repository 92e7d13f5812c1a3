"""What the CPU can check of the trace kernels without building them.

- Every `extern "C"` entry point of a CUDA source under
  prosper_tpu_torch/csrc has an argument table in its wrapper module of
  the same arity and kinds (pointer, int, float; the stream, which
  cuda_build.launch appends, aside), and every table entry names an
  entry point. ctypes passes what the table says, so a table that lags
  its source would cut a pointer or shift every later argument.
- The visit order the closest-hit kernels keep on exact t ties, on
  testing.make_tie_scene: the lockstep plain walk (trace_bvh's
  trace_closest_bvh_visits_plain, the one-thread walk of
  csrc/trace_bvh.cu that K2's warp-shared leaf tests must reproduce)
  keeps the lowest lane of a cluster and, across clusters, the one it
  visits first. Exact: tri ids, t, u, v bit for bit."""

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
from prosper_tpu_torch.testing import (
    CLUSTER_TRI_PAD,
    TIE_LANES,
    make_tie_scene,
)

torch.set_num_threads(2)

# source -> {entry point: the argument types its wrapper passes}
TABLES = {
    "trace_bvh": tb._ARGTYPES,
    "shade_tiles": {"shade_clustered_tiles": tst._ARGTYPES},
    "trace_flat": {name: tf._ARGTYPES for name in (
        "trace_closest_flat", "trace_closest_flat_full", "trace_any_flat")},
    "trace_leafmajor": {"run_pairs": lm._ARGTYPES},
    "trace_wavefront": {"walk_leaves": tw._ARGTYPES},
    "bench_kernels": {"isect_loop": bk._ISECT_ARGS, **bk._PROBE_ARGS},
}
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _kind(param: str):
    """The ctypes type a C parameter takes: pointers as c_void_p."""
    if "*" in param:
        return ctypes.c_void_p
    ctype = param.replace("const", "").split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]


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
