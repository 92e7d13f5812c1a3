"""On-disk asset caches: processed meshes and texture mip chains.

Counterpart of prosper_tpu/scene/caches.py without
`enable_compile_cache` (XLA's compilation cache; the port compiles its
kernels into build/kernels/, ops/cuda_build.py). The reference keeps
versioned caches (mesh cache v4, DeferredLoadingContext.cpp:492-660;
texture cache v5, Texture.cpp:78-165); here, with versions of their own:
- mesh cache: clustered and quantized mesh arrays in npz, keyed by
  (source path, mesh, primitive, mtime, version); a version mismatch or
  a stale mtime regenerates, like cacheValid;
- texture cache: RGBA8 mip chains in npz, keyed the same way.
The cache directory is `prosper_cache/` next to the scene, as in the
reference. Where it cannot be written, nothing is cached.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

# v4: binned-SAH triangle clustering; v5: meshlets within 64 vertices
# (scene/meshlets.py cluster_ranges), so a v4 file is not read
MESH_CACHE_VERSION = 5
TEXTURE_CACHE_VERSION = 1


def cache_dir(scene_path: str) -> str | None:
    """`prosper_cache/` next to the scene, or None where it cannot be
    written."""
    d = os.path.join(os.path.dirname(os.path.abspath(scene_path)),
                     "prosper_cache")
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, f".w{os.getpid()}")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return d
    except OSError:
        return None


def _key(*parts) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def mesh_cache_path(scene_path: str, mesh_index: int,
                    prim_index: int) -> str | None:
    d = cache_dir(scene_path)
    if d is None:
        return None
    key = _key("mesh", MESH_CACHE_VERSION, os.path.abspath(scene_path),
               _mtime(scene_path), mesh_index, prim_index)
    return os.path.join(d, f"mesh_{key}.npz")


def save_mesh_cache(path: str, arrays: dict) -> None:
    np.savez(path, __version__=MESH_CACHE_VERSION, **arrays)


def load_mesh_cache(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["__version__"]) != MESH_CACHE_VERSION:
                return None  # version mismatch: regenerate
            return {k: z[k] for k in z.files if k != "__version__"}
    except Exception:
        return None  # a torn or foreign file: regenerate


def texture_cache_path(scene_path: str, image_uri: str,
                       max_dim) -> str | None:
    d = cache_dir(scene_path)
    if d is None:
        return None
    src = os.path.join(os.path.dirname(os.path.abspath(scene_path)), image_uri)
    key = _key("tex", TEXTURE_CACHE_VERSION, os.path.abspath(src),
               _mtime(src), max_dim)
    return os.path.join(d, f"tex_{key}.npz")


def save_texture_cache(path: str, mips: list[np.ndarray], srgb: bool) -> None:
    np.savez(
        path,
        __version__=TEXTURE_CACHE_VERSION,
        __srgb__=int(srgb),
        n=len(mips),
        **{f"mip{i}": m for i, m in enumerate(mips)},
    )


def load_texture_cache(path: str) -> tuple[list[np.ndarray], bool] | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["__version__"]) != TEXTURE_CACHE_VERSION:
                return None
            mips = [z[f"mip{i}"] for i in range(int(z["n"]))]
            return mips, bool(int(z["__srgb__"]))
    except Exception:
        return None
