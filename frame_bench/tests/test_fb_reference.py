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
    code = """
import sys, numpy as np, torch
sys.path.insert(0, %r)
from frame_bench.inputs import camera, plate
from frame_bench.ref import deferred, pt, restir, shade, trace
inp = plate.make_plate_inputs(8, 5, 16, light_seed=5)
cam = {k: torch.as_tensor(np.asarray(v, np.float32))
       for k, v in camera.uniforms(inp["eye"], inp["target"], 32, 16).items()}
tris = trace.Triangles(inp["p0"], inp["p1"], inp["p2"], "cpu")
sd = shade.SceneData(inp, "cpu")
restir.render(tris, sd, cam, 32, 16, 0)
pt.render(tris, sd, cam, 32, 16, 0)
deferred.render(tris, sd, cam, 32, 16, 1, use_culling=True)
print(sorted({m.split(".")[0] for m in sys.modules}))
""" % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "prosper_tpu",
                       "prosper_tpu_torch"}
