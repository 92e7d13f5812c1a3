"""Every file of the benchmark parses and is found by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

from fb_helpers import ROOT

from frame_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_is_found():
    b = bench()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert (ROOT / c["file"]).is_file()
        spec.generator(cfg["generator"])
    for w in b["workloads"]:
        wl = spec.cell(w["name"])
        assert wl["config"] == w["config"]
        spec.reference(wl["entry"]["mode"])
        cmp = spec.comparison(wl["check"]["kind"])
        moving = (wl.get("camera", {}).get("kind", "static") != "static"
                  and wl["entry"].get("use_culling", False))
        want = set(cmp.NUMBERS) | (set(getattr(cmp, "MOVING", ()))
                                   if moving else set())
        assert set(wl["check"]["limits"]) == want
    for m in b["end_to_end"] + b["per_layer"]:
        ms = spec.metric(m["name"])
        assert hasattr(spec.reader(ms["reader"]), "read")


def test_every_file_is_named():
    b = bench()
    names = {d: {p.stem for p in (ROOT / "frame_bench" / d).glob("*.json")}
             for d in ("configs", "workloads", "metrics")}
    assert names["configs"] == {c["name"] for c in b["configs"]}
    assert names["workloads"] == {w["name"] for w in b["workloads"]}
    assert names["metrics"] == {m["name"] for m in b["end_to_end"] + b["per_layer"]}


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:
        _, per_layer = spec.cell_metrics(b, cell)
        assert per_layer
