"""On the card: each cell of BENCHMARK.json runs through run.py for a
few seconds and comes out correct, with its metrics. Skipped where torch
sees no card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from fb_helpers import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        p = subprocess.run([sys.executable, "frame_bench/run.py", "--workload",
                            cell["name"], "--seed", "2147483659", "--seconds",
                            "3", "--trace", str(trace)], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu" and line["metrics"]
