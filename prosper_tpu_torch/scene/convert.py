"""numpy scene dicts -> the port's device tensors.

The state the path tracer carries across frames is the scene. This
module puts it on the device once, as prosper_tpu/ops/trace.py
`prepare_geometry` (:82-112) does for the JAX package: the slabs, the
attribute rows, the packed material tables, the light uniforms and the
BVH arrays from accel/bvh.py, for a procedural scene (testing.py) or a
glTF World's static_scene_arrays(), frame_arrays() and texture arena.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.texture import pack_material_tables
from ..ops.trace import prepare_geometry


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array on `device`. To the card through pinned memory with
    a non-blocking copy on the current stream, so an upload between two
    frames does not wait for the frame still in flight."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    a = np.asarray(a)
    return torch.from_numpy(a.copy(order="C")).pin_memory().to(
        device, non_blocking=True)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:  # u32 words ride as int64 (no torch u32 ops)
        a = a.astype(np.int64)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return to_device(np.ascontiguousarray(a), device)


# World.frame_arrays keys that stay on the host: the BVH2 depth (an int,
# checked against the kernels' stack by World) and the scene camera
# (make_camera reads it)
HOST_ONLY = ("bvh_depth", "scene_camera")


def from_numpy_scene(static: dict, frame: dict, arena: dict, device) -> dict:
    """(static, frame, arena) numpy dicts (testing.make_test_scene
    layout, or a World's) -> {"static", "frame", "arena", "geom"} on
    `device`.

    geom: "tris", "packed9" (C, 9, 128), "packed_full" (C, 40, 128),
    "attr_rows" (C*128, 32); frame["bvh_bounds"] (N, 6) f32,
    frame["bvh_meta"] (N, 3) i32 and frame["bvh_nodes8"] (N8, 8, 8) f32
    where the frame carries them (a frame without the BVH2 arrays traces
    with the flat kernels, ops/trace.make_tracer); the frame's HOST_ONLY
    keys are left out; arena gains "mat_f32" / "mat_i32" and "one_mip",
    a bool: every texture has one mip (render/surface.py then samples an
    isotropic cone's base mip directly)."""
    static_t = static_tensors(static, device)
    frame_t = frame_tensors(frame, device)
    return {
        "static": static_t,
        "frame": frame_t,
        "arena": arena_tensors(arena, static["materials"], device),
        "geom": prepare_geometry(static_t, frame_t),
    }


def static_tensors(static: dict, device) -> dict:
    """A scene's static arrays on `device`, the material table left out
    (arena_tensors packs it)."""
    return {k: _tensor(v, device) for k, v in static.items()
            if k != "materials"}


def frame_tensors(frame: dict, device) -> dict:
    """A frame's arrays on `device`, its HOST_ONLY keys left out."""
    return {
        k: (
            {kk: _tensor(vv, device) for kk, vv in v.items()}
            if isinstance(v, dict)
            else _tensor(v, device)
        )
        for k, v in frame.items() if k not in HOST_ONLY
    }


def arena_tensors(arena: dict, materials: dict, device) -> dict:
    """The texture arena on `device` with the packed material tables
    ("mat_f32", "mat_i32") and "one_mip"."""
    arena_t = {k: _tensor(v, device) for k, v in arena.items()}
    arena_t["one_mip"] = bool((np.asarray(arena["n_mips"]) <= 1).all())
    mat_f32, mat_i32 = pack_material_tables(materials, arena)
    arena_t["mat_f32"] = _tensor(mat_f32, device)
    arena_t["mat_i32"] = _tensor(mat_i32, device)
    return arena_t


def camera_tensors(cam: dict, device) -> dict:
    """Camera uniforms (numpy or tensors) -> float32 tensors on device."""
    return {
        k: to_device(np.asarray(v, np.float32), device)
        if not isinstance(v, torch.Tensor) else v.to(device, torch.float32)
        for k, v in cam.items()
    }


def check_device(scene: dict, device) -> torch.device:
    """The device the scene lives on; raises unless it is `device`."""
    device = torch.device(device)
    got = scene["geom"]["packed_full"].device
    if got.type != device.type or (
        device.index is not None and got.index != device.index
    ):
        raise ValueError(f"scene lives on {got}, not on {device}")
    return got
