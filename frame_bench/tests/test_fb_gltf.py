"""A glTF configuration added as files alone: a scratch copy of the
benchmark gains a generator, a configuration, a deferred, culled cell
under an orbiting camera and their BENCHMARK.json entries, with no
existing file changed; the harness runs it on the CPU at 64x64 and it
comes out correct. Faults planted underneath, and the bfloat16 control,
come out not correct."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from fb_helpers import ROOT, make_tiny_root

from frame_bench.harness import bench, program, spec

CELL = "gtiny.deferred-culled-orbit"
CONFIG = {
    "name": "gtiny", "source": "a test scene", "generator": "gtiny_plates",
    "n_clusters": 48, "n_instanced": 16, "scatter_lights": 64,
    "light_range": 0.3, "layout_seed": 0, "texture_sizes": [64, 32, 32],
    "width": 64, "height": 64, "precision": "float32", "reduced": [],
}
WORKLOAD = {
    "config": "gtiny",
    "why": "a test cell: a textured glTF scene seen from an orbit",
    "entry": {"mode": "deferred", "use_culling": True, "bvh": True},
    "policy": {"any_tracer": "stack", "bounce_tracer": "packet"},
    "camera": {"kind": "orbit", "deg_per_frame": 10},
    "frames_in_flight": 2, "warmup_frames": 3, "trace_frames": 4,
    "check": {"kind": "frame", "display_atol": 1e-4, "hiz_rtol": 1e-4,
              "reference_options": ["use_culling"],
              "limits": {"pixels_off": 0.001, "count_off": 0.0,
                         "hiz_off": 0.01}},
}


def add_gltf_cell(root):
    """The files and entries of a glTF configuration and its cell."""
    fb = root / "frame_bench"
    shutil.copy(ROOT / "frame_bench/inputs/gltf_plates.py",
                fb / "inputs/gtiny_plates.py")
    (fb / "configs/gtiny.json").write_text(json.dumps(CONFIG))
    (fb / f"workloads/{CELL}.json").write_text(json.dumps(WORKLOAD))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gtiny", "source": "a test scene",
                         "file": "frame_bench/configs/gtiny.json",
                         "reduced": [], "why": "a test scene"})
    b["workloads"].append({"name": CELL, "config": "gtiny",
                           "traffic": "deferred-culled-orbit", "chips": 1,
                           "why": WORKLOAD["why"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture
def gltf_root(tmp_path):
    root = make_tiny_root(tmp_path)
    add_gltf_cell(root)
    return root


def run(root, seed=5):
    return bench.run(CELL, seed, 0.3, False, time.perf_counter(),
                     device="cpu", bench_root=root)


def test_added_as_files_alone(tmp_path):
    root = make_tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "frame_bench").rglob("*")
              if p.is_file()}
    add_gltf_cell(root)
    assert {p: p.read_bytes() for p in before} == before
    assert not spec.generator("gtiny_plates", root / "frame_bench").__file__\
        .startswith(str(ROOT))


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_sound_run_is_correct(gltf_root, seed):
    out = run(gltf_root, seed)
    checks = out["result"]["checks"]
    assert out["result"]["correct"] is True, checks
    assert set(checks) == {"pixels_off", "count_off", "hiz_off"}


def test_scene_file_is_removed_after_set_up(gltf_root):
    import os

    cell = bench.Cell(spec.cell(CELL, gltf_root / "frame_bench"), 3, "cpu")
    assert not os.path.exists(cell.inputs["scene_dir"])
    cell.free()


def _scene_fault(edit):
    """build_scene with the program's scene edited after it is built."""
    real = program.build_scene

    def build(inputs, bvh, device):
        scene = real(inputs, bvh, device)
        edit(scene)
        return scene
    return build


def _white_textures(scene):
    a = scene["arena"]
    a["mat_i32"][:, 1:3] = 0
    a["mat_i32"][:, 4:12] = a["table"][0, 0].repeat(2)


def _normal_map_dropped(scene):
    scene["arena"]["mat_i32"][:, 3] = 0


def _instance_moved(inputs, bvh, device, real=program.build_scene):
    """One instance node moved by 0.3 along x in the file, before the
    program loads it: the nearest to the eye of those whose plate faces
    the first frame's eye (the culler draws no plate seen from behind)."""
    from frame_bench.ref.trace import instances

    eye = inputs["eye"].astype(np.float64)
    facing = []
    for k, (mesh, m) in enumerate(instances(inputs["nodes"], inputs["roots"])):
        to_c = m[:3, 3] - eye
        if mesh == len(inputs["meshes"]) - 1 and np.dot(
                to_c, m[:3, :3] @ [0.0, 0.0, 1.0]) < 0:
            facing.append((np.linalg.norm(to_c), k))
    # instances before k: a plate node each, and the parent node before
    # the instanced ones: instance k is node k + 1
    k = 1 + min(facing)[1]
    doc = json.loads(open(inputs["gltf"]).read())
    doc["nodes"][k]["translation"][0] += 0.3
    with open(inputs["gltf"], "w") as f:
        json.dump(doc, f)
    return real(inputs, bvh, device)


def _camera_still(fn):
    first = []

    def f(scene, cam, i, state):
        first.append(cam)
        return fn(scene, first[0], i, state)
    return f


def _count_plus_one(fn):
    def f(scene, cam, i, state):
        img, new, stat = fn(scene, cam, i, state)
        return img, new, stat + 1
    return f


FRAME_FAULTS = [_camera_still, _count_plus_one]
SCENE_FAULTS = [_white_textures, _normal_map_dropped]


@pytest.mark.parametrize("fault", FRAME_FAULTS, ids=lambda f: f.__name__)
def test_frame_fault_is_not_correct(gltf_root, monkeypatch, fault):
    real = program.frame_call
    monkeypatch.setattr(program, "frame_call",
                        lambda *a, **k: fault(real(*a, **k)))
    out = run(gltf_root)
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.parametrize("fault", SCENE_FAULTS, ids=lambda f: f.__name__)
def test_scene_fault_is_not_correct(gltf_root, monkeypatch, fault):
    monkeypatch.setattr(program, "build_scene", _scene_fault(fault))
    out = run(gltf_root)
    assert out["result"]["correct"] is False, out["result"]["checks"]


def test_moved_instance_is_not_correct(gltf_root, monkeypatch):
    monkeypatch.setattr(program, "build_scene", _instance_moved)
    out = run(gltf_root)
    assert out["result"]["correct"] is False, out["result"]["checks"]


def test_light_left_out_of_its_froxels_is_not_correct(gltf_root, monkeypatch):
    """The light nearest the scene's centre, of finite range, is left out
    of every froxel's list (its sphere made to reach no tile)."""
    from prosper_tpu_torch.render import deferred

    real = deferred.build_tile_light_lists
    inputs = spec.generator("gtiny_plates", gltf_root / "frame_bench").make(
        CONFIG, 5)
    shutil.rmtree(inputs["scene_dir"])
    j = int(np.argmin(np.linalg.norm(inputs["point_position"]
                                     - inputs["target"], axis=1)))
    assert inputs["point_radius"][j] < np.linalg.norm(
        inputs["point_position"][j] - inputs["eye"])

    def lists(cam, lights, *a, **k):
        lights = dict(lights)
        r = lights["point_radius"].clone()
        r[j] = -1e30
        lights["point_radius"] = r
        return real(cam, lights, *a, **k)

    monkeypatch.setattr(deferred, "build_tile_light_lists", lists)
    out = run(gltf_root)
    assert out["result"]["correct"] is False, out["result"]["checks"]


def test_control_fails(gltf_root, capsys):
    """The reference in bfloat16 in the program's place fails a limit on
    3 seeds."""
    from frame_bench import readings

    limits = WORKLOAD["check"]["limits"]
    assert readings.main(["--workload", CELL, "--seeds", "1,2,3", "--frames",
                          "4", "--control", "--device", "cpu", "--root",
                          str(gltf_root)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        got = json.loads(line)
        assert all(got["program"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got


def test_reference_holds_the_programs_pyramid(gltf_root, monkeypatch):
    """A pyramid that the program builds wrong (all far: nothing hidden)
    is seen by hiz_off, though the count follows from it."""
    from prosper_tpu_torch.render import gbuffer

    real = gbuffer.build_hiz
    monkeypatch.setattr(gbuffer, "build_hiz",
                        lambda depth, w, h: [torch.zeros_like(m)
                                             for m in real(depth, w, h)])
    out = run(gltf_root)
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["hiz_off"]["value"] > 0.01


def test_reference_holds_the_pyramid_a_frame_starts_from(gltf_root,
                                                         monkeypatch):
    """The pyramid of the frame before the last (frame 5 of a traced run:
    3 warm-up frames, 4 in the window) left empty, and the last frame
    culled against it: the last frame is sound given that pyramid, and
    the pyramid it leaves is sound, so only the reference's own render
    of the frame before sees the fault (hiz_off)."""
    real = program.frame_call

    def faulty(*a, **k):
        fn = real(*a, **k)

        def f(scene, cam, i, state):
            img, new, stat = fn(scene, cam, i, state)
            if i == 5:
                new = dict(new, hiz=[torch.zeros_like(m) for m in new["hiz"]])
            return img, new, stat
        return f

    monkeypatch.setattr(program, "frame_call", faulty)
    out = bench.run(CELL, 5, 0.3, True, time.perf_counter(), device="cpu",
                    bench_root=gltf_root)
    assert "for frames [0, 3, 6]" in out["lines"][-4]  # the seed's frames
    assert out["result"]["correct"] is False
    assert out["result"]["checks"]["hiz_off"]["value"] > 0.01


def test_refused_clusters_are_not_correct(gltf_root, monkeypatch):
    """A partition that names one triangle twice is refused: the run ends
    with every number wholly off, not with an exception."""
    real = program.clusters

    def clusters(scene):
        got = real(scene)
        got["wt_aidx"][1] = got["wt_aidx"][0]
        return got

    monkeypatch.setattr(program, "clusters", clusters)
    out = run(gltf_root)
    assert out["result"]["correct"] is False
    assert any(line.startswith("clusters refused") for line in out["lines"])
