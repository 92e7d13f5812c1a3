"""The plain reference agrees with the program on the CPU at 64x64, and
imports nothing of the program, of JAX or of the JAX package."""

import json
import subprocess
import sys

import pytest

from fb_helpers import ROOT

from frame_bench.harness import spec


@pytest.mark.parametrize("mode", ["restir", "pt", "deferred-culled"])
def test_reference_agrees_with_the_program(tiny_root, mode, capsys):
    from frame_bench import readings

    assert readings.main(["--workload", f"tiny.{mode}", "--seeds", "3,2147483651",
                          "--frames", "4", "--device", "cpu", "--root",
                          str(tiny_root)]) == 0
    limits = spec.cell(f"tiny.{mode}", tiny_root / "frame_bench")["check"]["limits"]
    for line in capsys.readouterr().out.strip().splitlines():
        got = json.loads(line)["program"]
        assert all(got[k] <= limits[k] for k in limits), got


def test_reference_imports_nothing_of_the_program():
    """Both forms of inputs through the reference, the glTF form's
    clusters laid out by hand (each instance's triangles in order, 124
    a cluster), in a process that then holds no module of the program,
    of JAX or of the JAX package."""
    code = """
import shutil, sys, numpy as np, torch
sys.path.insert(0, %r)
from frame_bench.inputs import camera, gltf_plates, plate
from frame_bench.ref import deferred, pt, restir, shade, trace

def cam_of(inp, w, h):
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
            camera.uniforms(inp["eye"], inp["target"], w, h).items()}

inp = plate.make_plate_inputs(8, 5, 16, light_seed=5)
cam = cam_of(inp, 32, 16)
slots = trace.scene_slots(inp)
tris = trace.Triangles.from_slots(slots, "cpu")
sd = shade.SceneData(inp, slots, "cpu")
restir.render(tris, sd, cam, 32, 16, 0)
pt.render(tris, sd, cam, 32, 16, 0)
deferred.render(tris, sd, cam, 32, 16, 1, use_culling=True)

g = gltf_plates.make_inputs(6, 3, 8, 0.3, 0, (16, 8, 8), 9)
shutil.rmtree(g["scene_dir"])
insts = trace.instances(g["nodes"], g["roots"])
voff = np.cumsum([0] + [len(m["positions"]) for m in g["meshes"]])
aidx, count, owner = [], [], []
for i, (m, _) in enumerate(insts):
    idx = g["meshes"][m]["indices"] + voff[m]
    for s in range(0, len(idx), 124):
        part = idx[s:s + 124]
        aidx.append(np.concatenate([part, np.zeros((128 - len(part), 3), int)]))
        count.append(len(part))
        owner.append(i)
clusters = {"wt_aidx": np.concatenate(aidx), "wc_tri_count": np.array(count),
            "wc_instance": np.array(owner)}
slots = trace.scene_slots(g, clusters)
tris = trace.Triangles.from_slots(slots, "cpu")
sd = shade.SceneData(g, slots, "cpu")
cams = camera.camera_path({"kind": "orbit", "deg_per_frame": 10}, g["eye"],
                          g["target"], 32, 16)
cam = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in cams[0].items()}
deferred.render(tris, sd, cam, 32, 16, 0, use_culling=True)
print(sorted({m.split(".")[0] for m in sys.modules}))
""" % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "prosper_tpu",
                       "prosper_tpu_torch"}
