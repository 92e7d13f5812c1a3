"""ctypes bindings for the native C++ asset pipeline (cpp/asset_pipeline.cpp).

Counterpart of prosper_tpu/scene/native.py: the same entry points over
the same C++ source, which this module compiles itself, at first use,
with the flags of cpp/Makefile into <repo>/build/native/ (keyed by a hash
of the source and the flags), so the JAX package's own
cpp/libasset_pipeline.so is left alone. It reads the C++ source and
imports no Python module of the JAX package. Every entry point keeps its
numpy path for a machine without a C++ compiler, as in the JAX package;
`available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "cpp" / "asset_pipeline.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")  # cpp/Makefile

_LIB = None
_TRIED = False


def _build() -> Path | None:
    """The library for the current source, compiled unless it exists;
    None without a C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return None
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libasset_pipeline-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libasset_pipeline-{key}.{os.getpid()}.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    u64 = ctypes.c_uint64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.morton_order.argtypes = [f32p, u64, u32p, u64, u32p]
    lib.cluster_bounds.argtypes = [
        f32p, u32p, u32p, u32p, u64, f32p, f32p, f32p, f32p, f32p, f32p,
    ]
    lib.smooth_normals.argtypes = [f32p, u64, u32p, u64, f32p]
    lib.mikktspace_tangents.argtypes = [f32p, f32p, f32p, u64, u32p, u64, f32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def morton_order(positions: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """(T,) permutation sorting triangles along a Morton curve."""
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.uint32)
    n_tris = len(tris)
    if lib is None:
        from .meshlets import morton_order as np_morton

        p0 = positions[tris[:, 0]]
        p1 = positions[tris[:, 1]]
        p2 = positions[tris[:, 2]]
        return np_morton((p0 + p1 + p2) / 3.0).astype(np.uint32)
    out = np.empty(n_tris, np.uint32)
    lib.morton_order(positions, len(positions), tris.reshape(-1), n_tris, out)
    return out


def cluster_bounds(positions, tris, offsets, counts):
    """Per-cluster AABB/sphere/cone over pre-ordered triangles; None
    without the library (meshlets.build_clusters then takes numpy)."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.uint32).reshape(-1)
    offsets = np.ascontiguousarray(offsets, np.uint32)
    counts = np.ascontiguousarray(counts, np.uint32)
    c = len(offsets)
    aabb_min = np.empty((c, 3), np.float32)
    aabb_max = np.empty((c, 3), np.float32)
    center = np.empty((c, 3), np.float32)
    radius = np.empty(c, np.float32)
    axis = np.empty((c, 3), np.float32)
    cutoff = np.empty(c, np.float32)
    lib.cluster_bounds(
        positions, tris, offsets, counts, c,
        aabb_min.reshape(-1), aabb_max.reshape(-1), center.reshape(-1),
        radius, axis.reshape(-1), cutoff,
    )
    return aabb_min, aabb_max, center, radius, axis, cutoff


def smooth_normals_np(positions: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (prosper_tpu/scene/world.py
    `_smooth_normals`)."""
    n = np.zeros_like(positions)
    p0, p1, p2 = (positions[tris[:, i]] for i in range(3))
    fn = np.cross(p1 - p0, p2 - p0)  # area weighted
    for i in range(3):
        np.add.at(n, tris[:, i], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def smooth_normals(positions: np.ndarray, tris: np.ndarray) -> np.ndarray:
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    tris = np.ascontiguousarray(tris, np.uint32)
    if lib is None:
        return smooth_normals_np(positions, tris)
    out = np.empty_like(positions)
    lib.smooth_normals(
        positions, len(positions), tris.reshape(-1), len(tris), out.reshape(-1)
    )
    return out


def mikktspace_tangents(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    tris: np.ndarray,
) -> np.ndarray:
    """(V, 4) MikkTSpace-algorithm tangents + handedness: per-face dP/du
    tangents, projected onto the vertex normal plane and normalized per
    corner, angle-weighted, welded by exact (position, normal, uv) with
    mirrored wedges in separate groups (the reference's generateTangents,
    DeferredLoadingContext.cpp:266-338)."""
    lib = _load()
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    tris = np.ascontiguousarray(tris, np.uint32)
    if lib is not None:
        out = np.empty((len(positions), 4), np.float32)
        lib.mikktspace_tangents(
            positions, normals, uvs, len(positions), tris.reshape(-1),
            len(tris), out.reshape(-1),
        )
        return out

    # numpy path: the same algorithm, vectorised
    V = len(positions)
    key = np.concatenate([positions, normals, uvs], axis=1)
    _, canon = np.unique(
        key.view([("", np.float32)] * 8), return_inverse=True, axis=0
    )
    canon = canon.reshape(-1)

    p0, p1, p2 = (positions[tris[:, i]].astype(np.float64) for i in range(3))
    w0, w1, w2 = (uvs[tris[:, i]].astype(np.float64) for i in range(3))
    e1, e2 = p1 - p0, p2 - p0
    x1, x2 = w1[:, 0] - w0[:, 0], w2[:, 0] - w0[:, 0]
    y1, y2 = w1[:, 1] - w0[:, 1], w2[:, 1] - w0[:, 1]
    det = x1 * y2 - x2 * y1
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    tface = (e1 * y2[:, None] - e2 * y1[:, None]) * inv
    orient = (det < 0).astype(np.int64)

    acc = np.zeros((2 * V, 3), np.float64)
    wsum = np.zeros(2 * V, np.float64)
    pts = [p0, p1, p2]
    for c in range(3):
        n = normals[tris[:, c]].astype(np.float64)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        tp = tface - n * np.sum(n * tface, axis=1, keepdims=True)
        tl = np.linalg.norm(tp, axis=1, keepdims=True)
        good = ok & (tl[:, 0] > 1e-20)
        tp = np.where(good[:, None], tp / np.maximum(tl, 1e-20), 0.0)
        ea = pts[(c + 1) % 3] - pts[c]
        eb = pts[(c + 2) % 3] - pts[c]
        na = ea / np.maximum(np.linalg.norm(ea, axis=1, keepdims=True), 1e-20)
        nb = eb / np.maximum(np.linalg.norm(eb, axis=1, keepdims=True), 1e-20)
        ang = np.arccos(np.clip(np.sum(na * nb, axis=1), -1.0, 1.0))
        g = 2 * canon[tris[:, c]] + orient
        np.add.at(acc, g, tp * np.where(good, ang, 0.0)[:, None])
        np.add.at(wsum, g, np.where(good, ang, 0.0))

    out = np.empty((V, 4), np.float32)
    n = normals.astype(np.float64)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    g0 = 2 * canon
    use1 = wsum[g0 + 1] > wsum[g0]
    g = g0 + use1.astype(np.int64)
    tsum = acc[g]
    tp = tsum - n * np.sum(n * tsum, axis=1, keepdims=True)
    tl = np.linalg.norm(tp, axis=1, keepdims=True)
    bad = (wsum[g] <= 0.0) | (tl[:, 0] < 1e-20)
    ref = np.where(
        np.abs(n[:, 1:2]) < 0.99, np.array([[0.0, 1, 0]]), np.array([[1.0, 0, 0]])
    )
    fb = np.cross(ref, n)
    fb /= np.maximum(np.linalg.norm(fb, axis=1, keepdims=True), 1e-20)
    t = np.where(bad[:, None], fb, tp / np.maximum(tl, 1e-20))
    sign = np.where(bad, 1.0, np.where(use1, -1.0, 1.0))
    out[:, :3] = t.astype(np.float32)
    out[:, 3] = sign.astype(np.float32)
    return out
