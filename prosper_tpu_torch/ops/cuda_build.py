"""Build and load the package's CUDA kernels.

The sources under prosper_tpu_torch/csrc are compiled with nvcc into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into <repo>/build/kernels/, keyed by a
hash of the source, the shared headers (csrc/*.cuh) and the flags. The
library is loaded with ctypes.

Several processes may build at once (pytest-xdist workers on a machine
with a card): the build runs under a file lock and the finished library
is renamed into place atomically. `build_all` starts one nvcc for every
source at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("trace_bvh", "shade_tiles", "trace_flat", "trace_leafmajor",
           "trace_wavefront", "bench_kernels",
           "restir_spatial", "restir_initial")  # csrc/<name>.cu
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --fmad=false: no a*b+c contraction, so the kernels round every
# operation as the plain PyTorch versions do and agree with them bit for
# bit on hit/miss decisions at triangle edges.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME; the CUDA kernels "
        "cannot be built"
    )


def _build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for its current hash
    exists; returns the library's path."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process built it while we waited
                return lib
            tmp = BUILD_DIR / f".{name}-{key}.{os.getpid()}.so"
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}"
                )
            # ptxas -v: registers, spills and stack of each kernel
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build_all() -> dict[str, float]:
    """Build every source of SOURCES in parallel, one nvcc each; returns
    the wall seconds each build took (about 0 when it was cached)."""
    def timed(name):
        t0 = time.perf_counter()
        _build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(timed, SOURCES)))


def build_log(name: str) -> str:
    """The compiler's report (ptxas -v) for the current build of
    csrc/<name>.cu."""
    return _build(name).with_suffix(".log").read_text()


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    return ctypes.CDLL(str(_build(name)))


def launch(name: str, symbol: str, argtypes, device, args) -> None:
    """Call the C entry point `symbol` of csrc/<name>.cu with `args`
    (argtypes: their ctypes types) and the current stream of `device`,
    and raise if it returns a CUDA error."""
    import torch

    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {rc}")
