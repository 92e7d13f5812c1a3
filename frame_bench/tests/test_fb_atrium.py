"""The world-gltf configuration's generator (`inputs/gltf_atrium.py`) and
its cell, run by the harness on the CPU at 64x64 in a scratch copy of
the benchmark, on a small atrium (16,384 triangles, 32x32 textures, 64
lights) and an orbit of 30 degrees a frame: the program's meshlets pass
the reference's check (at most 124 triangles and 64 vertices a
cluster) and every compared frame is correct, as are the 8x8-quad
plates that the old 124-triangle ranges broke; a partition of up to 65
vertices a cluster, and the old ranges (the JAX package's partition),
are refused; the bfloat16 control is not correct."""

import json
import shutil
import time

import numpy as np
import pytest

from fb_helpers import ROOT, add_cell, make_tiny_root

from frame_bench.harness import bench, spec

BASE = "world-gltf.deferred-culled-orbit"
CELL = "atiny.deferred-culled-orbit"
SMALL = {"name": "atiny", "triangles": 16384, "texture_size": 32,
         "scatter_lights": 64, "width": 64, "height": 64}


@pytest.fixture
def atrium_root(tmp_path):
    root = make_tiny_root(tmp_path)
    cfg = json.loads((ROOT / "frame_bench/configs/world-gltf.json").read_text())
    cfg.update(SMALL)
    (root / "frame_bench/configs/atiny.json").write_text(json.dumps(cfg))
    add_cell(root, CELL, BASE, "atiny")
    path = root / "frame_bench/workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["camera"]["deg_per_frame"] = 30.0
    wl["trace_frames"] = 4
    path.write_text(json.dumps(wl))
    return root


def run(root, seed=5, trace=False):
    return bench.run(CELL, seed, 0.3, trace, time.perf_counter(),
                     device="cpu", bench_root=root)


def test_generator_writes_the_budget(tmp_path):
    """The world triangles, each instance counted, are the budget; 16
    meshes and materials; 32 column nodes, every third reflected; 0.55
    vertices a triangle or more on every mesh at the full size."""
    from frame_bench.inputs import gltf_atrium
    from frame_bench.ref.trace import instances

    for tris in (16384, 262144):
        inputs = gltf_atrium.make_inputs(tris, 8, 0.25, 0, 8, 3)
        shutil.rmtree(inputs["scene_dir"])
        insts = instances(inputs["nodes"], inputs["roots"])
        meshes = inputs["meshes"]
        assert sum(len(meshes[m]["indices"]) for m, _ in insts) == tris
        assert len(meshes) == len(inputs["materials"]["normal_tex"]) == 16
        column = gltf_atrium.MESH_ORDER.index("column")
        dets = [np.linalg.det(m[:3, :3]) for k, m in insts if k == column]
        assert len(dets) == 32 and sum(d < 0 for d in dets) == 11
    assert min(len(m["positions"]) / len(m["indices"]) for m in meshes) >= 0.55


@pytest.mark.parametrize("seed", [5, 2**31 + 77, 12])
def test_sound_runs_are_correct(atrium_root, seed):
    """Untraced runs: the first, a drawn and the last frame of the window
    correct, in clusters within upstream's limits."""
    out = run(atrium_root, seed)
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert set(out["result"]["checks"]) == {"pixels_off", "count_off",
                                            "hiz_off"}
    assert any("and 64 vertices a cluster" in line for line in out["lines"])


@pytest.mark.parametrize("seed", [7, 2**32 + 5])
def test_traced_run_is_correct_and_reads_cluster_fill(atrium_root, seed):
    """A traced run (frames 0, a drawn one and 6: orbit positions 0 to
    180 degrees) is correct and reports cluster_fill: the budget's
    triangles over the program's tiles of 128."""
    out = run(atrium_root, seed, trace=True)
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    n = int(out["lines"][0].split("clusters: ")[1].split(",")[0])
    assert res["metrics"]["cluster_fill"]["value"] == pytest.approx(
        100.0 * SMALL["triangles"] / (n * 128))
    assert 0.0 < res["metrics"]["culled_share"]["value"] < 100.0


def test_plates_of_8x8_quads_are_correct(tmp_path):
    """gltf_plates' scene with plates of 8x8 quads (81 vertices each),
    which the old ranges cut beyond 64 vertices a cluster, is correct."""
    root = make_tiny_root(tmp_path)
    fb = root / "frame_bench"
    src = (ROOT / "frame_bench/inputs/gltf_plates.py").read_text()
    assert "PLATE_QUADS = 7 " in src
    (fb / "inputs/plates8.py").write_text(
        src.replace("PLATE_QUADS = 7 ", "PLATE_QUADS = 8 "))
    (fb / "configs/p8.json").write_text(json.dumps({
        "name": "p8", "source": "a test scene", "generator": "plates8",
        "n_clusters": 48, "n_instanced": 16, "scatter_lights": 64,
        "light_range": 0.3, "layout_seed": 0, "texture_sizes": [64, 32, 32],
        "width": 64, "height": 64, "precision": "float32", "reduced": []}))
    add_cell(root, "p8.orbit", BASE, "p8")
    out = bench.run("p8.orbit", 5, 0.3, False, time.perf_counter(),
                    device="cpu", bench_root=root)
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert any("and 64 vertices a cluster" in line for line in out["lines"])


def _old_ranges(v, tris, *_):
    """The JAX package's partition: aligned 124-triangle SAH ranges."""
    from prosper_tpu_torch.scene.meshlets import sah_cluster_ranges

    return sah_cluster_ranges(np.asarray(v, np.float32),
                              np.asarray(tris).reshape(-1, 3).astype(np.uint32),
                              124)


def _up_to_65_vertices(v, tris, *_):
    from prosper_tpu_torch.scene.meshlets import meshlet_ranges

    return meshlet_ranges(np.asarray(v, np.float32),
                          np.asarray(tris).reshape(-1, 3).astype(np.uint32),
                          124, 65)


@pytest.mark.parametrize("ranges,why", [
    (_old_ranges, "hold more than 64 vertices (at most 1"),
    (_up_to_65_vertices, "hold more than 64 vertices (at most 65)")],
    ids=["old_ranges", "65_vertices"])
def test_partition_beyond_the_limits_is_refused(atrium_root, monkeypatch,
                                                ranges, why):
    """The reference's ClusterError ends the run with every number off."""
    from prosper_tpu_torch.scene import meshlets

    monkeypatch.setattr(meshlets, "cluster_ranges", ranges)
    out = run(atrium_root)
    assert out["result"]["correct"] is False
    refused = [line for line in out["lines"]
               if line.startswith("clusters refused")]
    assert refused and why in refused[0], out["lines"]


def test_control_fails(atrium_root, capsys):
    """The reference in bfloat16 in the program's place fails a limit on
    3 seeds, where the program keeps them all."""
    from frame_bench import readings

    limits = spec.cell(CELL, atrium_root / "frame_bench")["check"]["limits"]
    assert readings.main(["--workload", CELL, "--seeds", "1,2,3", "--frames",
                          "4", "--control", "--device", "cpu", "--root",
                          str(atrium_root)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        got = json.loads(line)
        assert all(got["program"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got
