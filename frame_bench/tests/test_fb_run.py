"""The harness end to end on the CPU at 64x64: the contract's last line,
a cell added by files and entries alone, and the refusals."""

import importlib.util
import json
import subprocess
import sys
import time

import pytest

from fb_helpers import ROOT, add_cell

from frame_bench.harness import bench

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def run_module():
    spec = importlib.util.spec_from_file_location("fb_run",
                                                  ROOT / "frame_bench/run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_line(capsys, out) -> dict:
    assert run_module().report(out) == 0
    got = capsys.readouterr()
    line = json.loads(got.out.strip().splitlines()[-1])
    # the numbers compared, each beside its limit, end standard error
    checks = list(line["checks"])
    err = got.err.strip().splitlines()[-len(checks):]
    assert [e.split(":")[0] for e in err] == [f"check {k}" for k in checks]
    return line


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_root, capsys, trace):
    out = bench.run("tiny.restir", 2**31 + 12345, 0.5, trace,
                    time.perf_counter(), device="cpu", bench_root=tiny_root)
    line = last_line(capsys, out)
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        assert "scene_setup_s" in names and "busy_s" in line["device"]
        assert "breakdown" in line
    else:
        assert names == {"frame_ms", "frame_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0


def test_new_cell_by_files_alone(tiny_root, capsys):
    """A workload file dropped into the copy, with its BENCHMARK.json
    entry, runs with no other file changed."""
    before = {p: p.read_bytes() for p in (tiny_root / "frame_bench").rglob("*")
              if p.is_file()}
    add_cell(tiny_root, "tiny.pt-2bounce", "plate2048-1k.pt", "tiny")
    wl_path = tiny_root / "frame_bench/workloads/tiny.pt-2bounce.json"
    wl = json.loads(wl_path.read_text())
    wl["entry"]["max_bounces"] = 2
    wl_path.write_text(json.dumps(wl))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    out = bench.run("tiny.pt-2bounce", 99, 0.5, False, time.perf_counter(),
                    device="cpu", bench_root=tiny_root)
    assert last_line(capsys, out)["correct"] is True


def test_refuses_without_a_card(tmp_path):
    """No result line and a non-zero exit where torch sees no card; the
    CUDA build of torch on the card takes the other branch."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "frame_bench/run.py"),
                        "--workload", "plate2048-1k.restir", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory with BENCHMARK.json and frame_bench/ alone."""
    import shutil

    shutil.copytree(ROOT / "frame_bench", tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "frame_bench/run.py", "--workload",
                        "plate2048-1k.restir", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_when_jax_is_loaded(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "prosper_tpu", object())
    assert run_module().report({"lines": [], "result": {}}) == 3
    assert capsys.readouterr().out == ""


def test_frame_percentile_skips_the_traced_start():
    """A traced window's first interval holds the profiler's start;
    `skip` leaves it out, and without it the percentile is as before."""
    from frame_bench.readers import frame_percentile

    ctx = {"window": {"intervals_ms": [3600.0] + [40.0] * 15}}
    assert frame_percentile.read(ctx, 95, skip=1) == 40.0
    assert frame_percentile.read(ctx, 95) > 500.0
    assert frame_percentile.read({"window": {"intervals_ms": [5.0]}}, 95,
                                 skip=1) is None
