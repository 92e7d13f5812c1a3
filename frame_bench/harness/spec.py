"""The benchmark's data, found by name.

BENCHMARK.json (at the checkout's root) names the cells and metrics; each
cell is `workloads/<name>.json`, each configuration `configs/<name>.json`,
each per-layer metric `metrics/<name>.json` (a reader of `readers/` and
its parameters). Adding a cell, a configuration or a metric adds files
and entries; no code changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The workload file of a cell, with its configuration file under
    "config_data"."""
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload file {path}")
    wl = load_json(path)
    wl["name"] = name
    wl["config_data"] = config(wl["config"], bench_dir)
    wl["bench_dir"] = str(bench_dir)
    return wl


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "configs" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no configuration file {path}")
    return load_json(path)


def metric(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "metrics" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no metric file {path}")
    return load_json(path)


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that the
    cell reports: those without a "workloads" key, and those whose list
    names it."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def generator(name: str, bench_dir: Path = BENCH_DIR):
    """The scene generator module `inputs/<name>.py` of the benchmark in
    `bench_dir` (its make(config, seed) gives the raw inputs); a module
    of frame_bench.inputs, whose siblings it may import."""
    if Path(bench_dir).resolve() == BENCH_DIR:
        return importlib.import_module(f"frame_bench.inputs.{name}")
    path = Path(bench_dir) / "inputs" / f"{name}.py"
    found = importlib.util.spec_from_file_location(
        f"frame_bench.inputs.{name}", path)
    if found is None or not path.is_file():
        raise KeyError(f"no generator file {path}")
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


def reader(name: str):
    """A per-layer metric's reader `readers/<name>.py` (read(ctx,
    **params) -> number or None)."""
    return importlib.import_module(f"frame_bench.readers.{name}")


def comparison(kind: str):
    """The comparison of a kind of frame `compare/<kind>.py`: keep()
    what a frame leaves to judge, numbers() against the reference,
    control() for the lower-precision control."""
    return importlib.import_module(f"frame_bench.compare.{kind}")


def reference(mode: str):
    """The plain reference of a frame mode `ref/<mode>.py`."""
    return importlib.import_module(f"frame_bench.ref.{mode}")
