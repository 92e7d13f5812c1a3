"""On the card: one frame of each cell of BENCHMARK.json makes as many
synchronising calls, as torch.cuda.set_sync_debug_mode("warn") counts
them, as the program opens wait spans (the count `waits_per_frame`
reads). Skipped where torch sees no card (decided inside the test)."""

import json
import warnings

import pytest

from fb_helpers import ROOT

from frame_bench.harness import bench, spec


@pytest.mark.cuda
def test_wait_spans_count_the_synchronising_calls():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from prosper_tpu_torch.utils.profiler import gprofiler

    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    for name in (c["name"] for c in cells):
        cell = bench.Cell(spec.cell(name), 2147483659, "cuda")
        for _ in range(2):
            cell.frame()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught, \
                gprofiler.recording():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, cell.state, _ = cell.fn(cell.scene, cell.cams[0],
                                           cell.index, cell.state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [w for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        frame = gprofiler.frames(1)[0]
        sites = [s.name for s in frame.spans if s.kind == "wait"]
        assert frame.index == cell.index and frame.spans[0].kind == "frame"
        assert len(syncs) == len(sites) >= 1, (name, sites, [
            f"{w.filename}:{w.lineno}" for w in syncs])
        cell.free()
