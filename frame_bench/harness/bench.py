"""One run of one cell: set-up, the measured (or traced) window of frames,
the comparison with the plain reference, the result line.

Frames are dispatched back to back, at most `frames_in_flight` at once
(before frame i is dispatched, frame i - frames_in_flight has ended), as
the renderer's CLI and sndels/prosper (MAX_FRAMES_IN_FLIGHT = 2) keep
them. An event recorded after each frame's last work marks its end;
nothing else waits inside a frame.
"""

from __future__ import annotations

import gc
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, program, spec, trace_read

FORBIDDEN = ("jax", "jaxlib", "flax", "prosper_tpu")


class Marks:
    """End-of-frame marks: CUDA events on the card; on the CPU, whose
    work is done when a call returns, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, back: int):
        """Wait for the frame `back` marks before the newest one ends."""
        if self.cuda and len(self.marks) >= back:
            self.marks[-back].synchronize()

    def intervals_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [m[i - 1].elapsed_time(m[i]) for i in range(1, len(m))]
        return [(m[i] - m[i - 1]) * 1e3 for i in range(1, len(m))]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell's inputs, the program's scene and frame call, and its
    frame loop."""

    def __init__(self, wl: dict, seed: int, device):
        cfg = wl["config_data"]
        self.wl, self.seed, self.device = wl, int(seed), device
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        t0 = time.perf_counter()
        gen = spec.generator(cfg["generator"],
                             Path(wl.get("bench_dir", spec.BENCH_DIR)))
        self.inputs = gen.make(cfg, seed)
        self.inputs_s = time.perf_counter() - t0
        from frame_bench.inputs.camera import camera_path

        self.cam_np = camera_path(wl.get("camera", {"kind": "static"}),
                                  self.inputs["eye"], self.inputs["target"],
                                  self.width, self.height)
        program.set_policy(wl.get("policy", {}))
        opts = {"bvh": True, **wl["entry"]}
        t0 = time.perf_counter()
        self.scene = program.build_scene(self.inputs, opts["bvh"], device)
        sync(device)
        self.scene_setup_s = time.perf_counter() - t0
        self.n_clusters = int(self.scene["static"]["wc_tri_count"].shape[0])
        if "scene_dir" in self.inputs:  # the glTF form's file, now read
            shutil.rmtree(self.inputs["scene_dir"], ignore_errors=True)
        self.cams = [program.camera(c, device) for c in self.cam_np]
        self.fn = program.frame_call(opts, self.width, self.height, device)
        self.compare = spec.comparison(wl["check"]["kind"])
        self.state = self.older = None
        self.clusters = None
        self.index = 0
        self.marks = Marks(device)
        self.in_flight = int(wl.get("frames_in_flight", 2))

    def frame(self):
        """Dispatch the next frame; returns what the comparison keeps of
        it (references, no copies)."""
        self.marks.wait(self.in_flight)
        i = self.index
        older, prev = self.older, self.state
        img, self.state, stat = self.fn(self.scene, self.cams[i % len(self.cams)],
                                        i, self.state)
        self.marks.mark()
        self.index += 1
        kept = self.compare.keep(prev, img, self.state, stat, older)
        if len(self.cams) == 1:  # the pyramids matter to a moving camera alone
            for k in ("older_hiz", "prev_hiz", "hiz"):
                kept.pop(k, None)
        else:  # and it alone holds a state two frames back
            self.older = prev
        return dict(kept, index=i)

    def free(self):
        """Drop the program's scene, frame call and state, keeping its
        partition into clusters (program.clusters), which the reference
        of a glTF scene reads."""
        if self.scene is not None:
            self.clusters = program.clusters(self.scene)
        self.scene = self.fn = self.state = self.older = self.cams = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def window(cell: Cell, seconds: float | None, frames: int | None) -> dict:
    """Frames back to back until `seconds` have passed on the host clock
    (or `frames` are dispatched), then a wait for the last. Returns the
    window's seconds, frame count, frame intervals, counts, and the
    outputs of the last frame and of one frame drawn from the seed,
    uniformly over the window (reservoir sampling: frame n replaces the
    drawn one with probability 1 / n)."""
    first = len(cell.marks.marks) - 1
    draw = np.random.default_rng(cell.seed)
    kept, stats = {}, []
    t0 = time.perf_counter()
    n = 0
    while True:
        out = cell.frame()
        stats.append(out["stat"])
        n += 1
        if draw.random() * n < 1.0:
            kept["drawn"] = out
        kept["last"] = out
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
        if frames is not None and n >= frames:
            break
    sync(cell.device)
    wall = time.perf_counter() - t0
    return {"seconds": wall, "frames": n,
            "intervals_ms": cell.marks.intervals_ms()[first:],
            "stats": [float(s) for s in stats], "kept": kept}


def _to(v, device):
    """A kept value (a tensor, a list of them, or neither) on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, list):
        return [_to(x, device) for x in v]
    return v


def reference_numbers(wl: dict, inputs: dict, cam_np: list, width: int,
                      height: int, frames: list[dict], device,
                      control_dtype=None, clusters=None,
                      notes=None) -> list[dict]:
    """The comparison's numbers of each kept frame (on `device`); with
    control_dtype, those of the control: the reference computed in that
    dtype put in the program's place. clusters: the program's
    (program.clusters), which the reference of a glTF scene checks and
    lays its triangles out in; the clusters' sizes are added to `notes`."""
    from frame_bench.ref import shade
    from frame_bench.ref.trace import Triangles, scene_slots

    mode = spec.reference(wl["entry"]["mode"])
    chk = wl["check"]
    compare = spec.comparison(chk["kind"])
    slots = scene_slots(inputs, clusters)
    if slots["cluster_vertices"] is not None and notes is not None:
        notes.append(f"clusters: {len(slots['count'])}, at most "
                     f"{int(slots['count'].max())} triangles and "
                     f"{slots['cluster_vertices']} vertices a cluster "
                     f"(upstream's meshlets: 124, 64)")
    tris = Triangles.from_slots(slots, device)
    sd = shade.SceneData(inputs, slots, device)
    sd_ctl = None if control_dtype is None else shade.SceneData(
        inputs, slots, device, control_dtype)
    del slots
    lut = torch.as_tensor(shade.display_lut(), device=device)
    opts = {k: wl["entry"][k] for k in chk.get("reference_options", [])}

    def camera_of(index):
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in cam_np[index % len(cam_np)].items()}

    moving = len(cam_np) > 1 and bool(opts.get("use_culling"))

    def render(scene_data, port, index):
        """(sample, count, extra) of the reference. Under a moving camera
        with culling, the frame before (from the program's pyramid of
        the frame before that) is rendered first, and the compared frame
        starts from the pyramid it leaves (extra["hiz_before"])."""
        kw, before = dict(opts), {}
        if moving and index > 0:
            kw["prev_hiz"] = mode.pyramid(tris, scene_data, camera_of(index - 1),
                                          width, height, index - 1,
                                          port.get("older_hiz"))
            before["hiz_before"] = kw["prev_hiz"]
        got = mode.render(tris, scene_data, cam, width, height, index, **kw)
        sample, count, extra = got if len(got) == 3 else (*got, {})
        return sample, count, dict(extra, **before)

    out = []
    for f in frames:
        cam = camera_of(f["index"])
        port = {k: _to(v, device) for k, v in f.items()}
        if sd_ctl is not None:
            port = compare.control(port, *render(sd_ctl, port, f["index"]),
                                   lut, control_dtype)
        sample, count, extra = render(sd, port, f["index"])
        out.append(compare.numbers(port, sample, count, lut, chk, extra))
    return out


def warm_up(cell: Cell) -> dict:
    """The cell's warm-up frames (the first starts the accumulation);
    returns what the comparison keeps of the first."""
    start = cell.frame()
    for _ in range(int(cell.wl.get("warmup_frames", 3)) - 1):
        cell.frame()
    sync(cell.device)
    return start


def compared_frames(cell: Cell, start: dict, win: dict) -> list[dict]:
    """The first warm-up frame, the drawn and the last window frame, on
    the host; then the program's state is freed."""
    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if isinstance(v, list):
            return [host(x) for x in v]
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", torch.float32)
        return v

    kept = [host(start), host(win["kept"]["drawn"]), host(win["kept"]["last"])]
    win["kept"] = None
    cell.free()
    return kept


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", bench_root=None) -> dict:
    """One run; returns {"result": the result line's dict, "lines": the
    check lines for standard error}."""
    root = bench_root or spec.ROOT
    wl = spec.cell(workload, root / "frame_bench")
    e2e, per_layer = spec.cell_metrics(spec.benchmark(root), workload)
    t_cell = time.perf_counter()
    cell = Cell(wl, seed, device)
    t_warm = time.perf_counter()
    start = warm_up(cell)
    setup_s = time.perf_counter() - t_start
    setup_parts = {"start to cell": t_cell - t_start, "inputs": cell.inputs_s,
                   "scene": cell.scene_setup_s,
                   "warm-up": time.perf_counter() - t_warm}

    ctx = {"scene_setup_s": cell.scene_setup_s, "setup_s": setup_s,
           "config": wl["config_data"], "n_clusters": cell.n_clusters}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        table = spec.load_json(root / "frame_bench" / "trace_calls.json")
        with program.TraceCalls(table) as calls, profile(activities=acts) as prof:
            sync(device)
            win = window(cell, None, int(wl.get("trace_frames", 8)))
        ctx["trace"] = trace_read.reduce(prof.events(), win["frames"],
                                         win["seconds"])
        ctx["trace_calls"] = calls.calls
    else:
        win = window(cell, seconds, None)
    ctx.update(window=win, stats=win["stats"])
    mem = (torch.cuda.max_memory_allocated(device)
           if torch.device(device).type == "cuda" else 0)

    kept = compared_frames(cell, start, win)
    del start
    t_ref = time.perf_counter()
    from frame_bench.ref.trace import ClusterError

    notes = []
    try:
        per_frame = reference_numbers(wl, cell.inputs, cell.cam_np, cell.width,
                                      cell.height, kept, device,
                                      clusters=cell.clusters, notes=notes)
    except ClusterError as e:  # every number wholly off
        per_frame = [{k: 1.0 for k in wl["check"]["limits"]}]
        notes.append(f"clusters refused: {e}")
    ref_s = time.perf_counter() - t_ref
    correct, checks = check.judge(check.worst(per_frame), wl["check"]["limits"])

    metrics = {}
    for m in (per_layer if trace else e2e):
        mspec = spec.metric(m["name"], root / "frame_bench")
        val = spec.reader(mspec["reader"]).read(ctx, **mspec.get("params", {}))
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct), "attempted": win["frames"], "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    lines = notes + ["set-up: " + "; ".join(f"{k} {v:.3f} s"
                                            for k, v in setup_parts.items()),
             f"reference: {ref_s:.3f} s for frames "
             f"{[f['index'] for f in kept]}; per frame {per_frame}"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in checks.items()]
    return {"result": result, "lines": lines, "per_frame": per_frame}
