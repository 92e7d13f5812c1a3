"""Helpers of the frame benchmark's tests."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"n_clusters": 64, "width": 64, "height": 64}


def add_cell(root: Path, name: str, base: str, config: str):
    """A new cell `name` in the scratch copy: a workload file copied from
    cell `base` onto `config`, and its entries in BENCHMARK.json (the
    per-layer metrics of `base` list it too)."""
    wl = json.loads((root / "frame_bench/workloads" / f"{base}.json").read_text())
    wl["config"] = config
    (root / "frame_bench/workloads" / f"{name}.json").write_text(json.dumps(wl))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": name.split(".")[-1], "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if base in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def make_tiny_root(dest: Path) -> Path:
    """A scratch copy of BENCHMARK.json and frame_bench/ with a tiny
    configuration and the cells tiny.restir, tiny.pt and
    tiny.deferred-culled."""
    shutil.copytree(ROOT / "frame_bench", dest / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    cfg = json.loads((ROOT / "frame_bench/configs/plate2048-1k.json").read_text())
    cfg.update(TINY, name="tiny")
    (dest / "frame_bench/configs/tiny.json").write_text(json.dumps(cfg))
    add_cell(dest, "tiny.deferred-culled", "plate2048-1k.deferred-culled",
             "tiny")
    for mode in ("restir", "pt"):
        add_cell(dest, f"tiny.{mode}", f"plate2048-1k.{mode}", "tiny")
        # a 64x64 frame counts a few hundred shadow-ray pixels, so one
        # pixel whose light flips at a plate's edge moves count_off by
        # about 0.005, where 1080p frames read under 4e-4
        path = dest / "frame_bench/workloads" / f"tiny.{mode}.json"
        wl = json.loads(path.read_text())
        wl["check"]["limits"]["count_off"] = 0.02
        path.write_text(json.dumps(wl))
    return dest
