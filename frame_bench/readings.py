"""The readings that the limits of `correct` are set from.

    python3 frame_bench/readings.py --workload <cell> --seeds 1,2,3 [--frames 12] [--control]

For each seed, in one process: the cell's set-up, a short window of
`--frames` frames at the cell's own size, and the comparison's numbers of
the compared frames (the program's; the lower readings). With --control,
also the numbers of the control: the plain reference computed with its
shading, its display transform and its culling in bfloat16, put in the
program's place (its sample of each compared frame accumulated as the program's
would be) and judged by the same comparison against the float32
reference (the upper readings).
One JSON line per seed; needs a CUDA device unless --device cpu (tests).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    import torch

    from frame_bench.harness import bench, check, spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(args.root) if args.root else spec.ROOT
    wl = spec.cell(args.workload, root / "frame_bench")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = bench.Cell(wl, seed, args.device)
        start = bench.warm_up(cell)
        win = bench.window(cell, None, args.frames)
        kept = bench.compared_frames(cell, start, win)
        del start
        inputs, cam_np, W, H = cell.inputs, cell.cam_np, cell.width, cell.height
        prog = bench.reference_numbers(wl, inputs, cam_np, W, H, kept,
                                       args.device, clusters=cell.clusters)
        line = {"workload": args.workload, "seed": seed, "size": [W, H],
                "frames": [f["index"] for f in kept],
                "program": check.worst(prog), "program_frames": prog}
        if args.control:
            ctl = bench.reference_numbers(wl, inputs, cam_np, W, H, kept,
                                          args.device, torch.bfloat16,
                                          clusters=cell.clusters)
            line["control"] = check.worst(ctl)
            line["control_frames"] = ctl
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
