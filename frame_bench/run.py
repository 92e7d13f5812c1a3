"""Run one cell of the frame benchmark of prosper_tpu_torch.

    python3 frame_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds prosper_tpu_torch. The last line
of standard output is the result's JSON object; the comparison's numbers,
each beside its limit, are the last lines of standard error. Exits 2
without a CUDA device (or with fewer than the cell asks for), 3 when a
module of JAX or of the JAX package is loaded at the end, 1 when the
cell cannot run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed paths inside the checkout (the port's nvcc
# builds go to build/kernels/ and its native library to build/native/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "prosper_tpu_torch").is_dir():
        print("prosper_tpu_torch is not in this checkout", file=sys.stderr)
        return 1
    from frame_bench.harness import spec

    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 1
    import torch

    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from frame_bench.harness import bench as bench_run

    return report(bench_run.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START, device="cuda"))


def report(out: dict) -> int:
    """Refuse the run if JAX or the JAX package is loaded; else print the
    check lines to standard error and the result as the last line of
    standard output."""
    from frame_bench.harness.bench import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
