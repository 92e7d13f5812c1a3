"""Geometry prep, the tracer policy and pixel order for the trace
kernels.

Counterpart of prosper_tpu/ops/trace.py: `world_triangles` (:383),
`prepare_geometry` (:82), `GeometryCache` (:126), `make_tracer` (:33),
`bounce_policy` and `make_bounce_tracer` (:162-217), `frame_bvh` (:220),
`block_pixel_order` (:227), `block_inverse16` (:343) and `permute16`
(:355). The pixel orders are numpy and cached per resolution, as
render/pt.py `_packed_pixels` caches them.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch

TILE = 256  # rays per pixel tile: one 16x16 screen block
CLUSTER_PAD = 128  # triangles per cluster slab (scene/meshlets.py)


def xf_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-row affine transform: m (S, 3, 4), p (S, 3) -> (S, 3)."""
    return (m[:, :, :3] * p[:, None, :]).sum(-1) + m[:, :, 3]


def xf_dirs(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row linear transform: m (S, 3, >=3), v (S, 3) -> (S, 3)."""
    return (m[:, :, :3] * v[:, None, :]).sum(-1)


def world_triangles(static_scene: dict, frame: dict) -> dict:
    """Object-space cluster triangles -> world space {v0, e1, e2} (S, 3),
    each triangle through its instance's 3x4 transform."""
    m = frame["transforms"][static_scene["wt_instance"]]  # (S, 3, 4)
    p0 = xf_points(m, static_scene["wt_p0"])
    p1 = xf_points(m, static_scene["wt_p1"])
    p2 = xf_points(m, static_scene["wt_p2"])
    return {"v0": p0, "e1": p1 - p0, "e2": p2 - p0}


def prepare_geometry(static_scene: dict, frame: dict) -> dict:
    """World-space geometry for the trace kernels, built once per
    transform set: {"tris", "packed9" (C, 9, 128), "packed_full"
    (C, 40, 128), "attr_rows" (C*128, 32)}."""
    from .slabs import attr_rows_from_packed, pack_tris, pack_tris_full

    tris = world_triangles(static_scene, frame)
    packed_full = pack_tris_full(static_scene, frame)
    return {
        "tris": tris,
        "packed9": pack_tris(tris),
        "packed_full": packed_full,
        "attr_rows": attr_rows_from_packed(packed_full),
    }


class GeometryCache:
    """Host-side pacing of prepare_geometry, the static BLAS + per-frame
    TLAS of the reference: the geometry is recomputed only when the
    instance transforms change (animation); otherwise the same device
    tensors come back."""

    def __init__(self) -> None:
        self._key = None
        self._val = None

    def get(self, static_scene: dict, transforms, normal_transforms) -> dict:
        """static_scene: the static tensors on their device; transforms
        (I, 3, 4) and normal_transforms (I, 3, 3): a World frame's numpy
        arrays, compared on the host."""
        transforms = np.asarray(transforms, np.float32)
        normal_transforms = np.asarray(normal_transforms, np.float32)
        key = (transforms.tobytes(), normal_transforms.tobytes())
        if self._val is None or key != self._key:
            dev = static_scene["wt_p0"].device
            frame = {"transforms": torch.as_tensor(transforms, device=dev),
                     "normal_transforms": torch.as_tensor(normal_transforms,
                                                          device=dev)}
            self._val = prepare_geometry(static_scene, frame)
            self._key = key
        return self._val


def frame_bvh(frame: dict):
    """(bounds, meta) of a frame's BVH2 node arrays, or None when the
    frame carries none."""
    if "bvh_bounds" in frame and "bvh_meta" in frame:
        return frame["bvh_bounds"], frame["bvh_meta"]
    return None


def make_tracer(slabs, wc_min, wc_max, bvh=None):
    """The one tracer policy: (closest_fn, any_fn), each called as
    fn(o, d, t_min, t_max); closest_fn returns (R, 8) rows t | tri | u |
    v | pad, any_fn (R,) bool.

    With `bvh` = (bounds, meta): K2 closest, and the any hit that
    config.policy.any_tracer names, read at this call: "stack" K3, the
    BVH2 walk; "dense" K10, the packet's dense cull
    (prosper_tpu/ops/trace.py:58-69). Without: the flat cull-list kernels
    over the cluster AABBs (wc_min, wc_max), inverted where a cluster is
    masked: K6 closest, K7 any hit."""
    from .. import config
    from . import trace_bvh, trace_flat

    policy = config.policy.any_tracer
    if policy not in config.ANY_TRACERS:
        raise ValueError(f"unknown any_tracer policy {policy!r}; expected "
                         f"one of {config.ANY_TRACERS}")
    if bvh is not None:
        bounds, meta = bvh
        any_impl = (trace_bvh.trace_any_bvh_dense if policy == "dense"
                    else trace_bvh.trace_any_bvh)
        return (partial(trace_bvh.trace_closest_bvh, slabs, bounds, meta),
                partial(any_impl, slabs, bounds, meta))
    return (partial(trace_flat.trace_closest_flat, slabs, wc_min, wc_max),
            partial(trace_flat.trace_any_flat, slabs, wc_min, wc_max))


LEAFMAJOR_MAX_CLUSTERS = 4096  # the tile cull is O(tiles x C)


def bounce_policy(n_clusters: int, bvh, prefer: str | None = None) -> bool:
    """True when incoherent rays take the leaf-major tracer: the
    preference (prefer, else config.policy.bounce_tracer, read at this
    call) is "leafmajor", the frame has BVH arrays (the heavy rays need
    K2/K3) and n_clusters <= LEAFMAJOR_MAX_CLUSTERS. An unknown name
    raises. The JAX package also returns False on its CPU backend
    (prosper_tpu/ops/trace.py:176); the port has one structure on every
    device, and the CPU runs K14's plain version."""
    from .. import config

    if prefer is None:
        prefer = config.policy.bounce_tracer
    if prefer not in config.BOUNCE_TRACERS:
        raise ValueError(f"unknown bounce_tracer policy {prefer!r}; expected "
                         f"one of {config.BOUNCE_TRACERS}")
    return (prefer == "leafmajor" and bvh is not None
            and n_clusters <= LEAFMAJOR_MAX_CLUSTERS)


def make_bounce_tracer(slabs, wc_min, wc_max, bvh, prefer=None):
    """The incoherent-ray policy (prosper_tpu/ops/trace.py:182-217): None
    when callers keep their packet path (bounce_policy is False), else
    {"any": fn(o, d, t_min, t_max) -> (R,) bool, "closest_full": fn(o,
    d, t_min, t_max) -> the full hit dict (t = inf on a miss), or None
    when slabs has fewer than 38 rows}, both the exact hybrid of
    ops/trace_leafmajor.py (K14 for light rays, K2/K3 for heavy ones)."""
    if not bounce_policy(wc_min.shape[0], bvh, prefer):
        return None
    from . import trace_leafmajor as lm

    bounds, meta = bvh
    closest_full = None
    if slabs.shape[1] >= 38:
        closest_full = partial(lm.trace_closest_leafmajor_full_safe, slabs,
                               bounds, meta, wc_min, wc_max)
    return {"any": partial(lm.trace_any_leafmajor_safe, slabs, bounds, meta,
                           wc_min, wc_max),
            "closest_full": closest_full}


def block_pixel_order(width: int, height: int, block: int = 16):
    """Pixel order grouping 16x16 screen blocks into 256-ray tiles.

    Returns (px, py, inverse): px, py (R,) uint32 in block order, and
    `inverse` with row_major = blocked[inverse]."""
    bx = -(-width // block)
    by = -(-height // block)
    ys, xs = np.meshgrid(
        np.arange(by * block), np.arange(bx * block), indexing="ij"
    )
    order = np.argsort(
        ((ys // block) * bx + (xs // block)) * (block * block)
        + (ys % block) * block
        + (xs % block),
        axis=None,
        kind="stable",
    )
    px = (xs.reshape(-1)[order]).astype(np.uint32)
    py = (ys.reshape(-1)[order]).astype(np.uint32)
    keep = (px < width) & (py < height)
    px, py = px[keep], py[keep]
    flat = py.astype(np.int64) * width + px.astype(np.int64)
    inverse = np.argsort(flat, kind="stable")
    return px, py, inverse


def block_inverse16(width: int, height: int, block: int = 16):
    """Segment-level inverse of block_pixel_order: row-major 16-pixel
    segment s is block-order segment inv16[s] (width % 16 == 0)."""
    if width % 16:
        raise ValueError(f"width must be a multiple of 16, got {width}")
    _, _, inverse = block_pixel_order(width, height, block)
    return (inverse[::16] // 16).astype(inverse.dtype)


def permute16(a: torch.Tensor, inv16: torch.Tensor) -> torch.Tensor:
    """Apply a segment-level permutation (block_inverse16) to (R, ...)."""
    R = a.shape[0]
    seg = a.reshape((R // 16, 16) + tuple(a.shape[1:]))
    return seg[inv16].reshape(a.shape)


@lru_cache(maxsize=4)
def pixel_layouts_np(width: int, height: int):
    """numpy (px, py, pix_cols, inv16) for one resolution: block-order
    pixel coordinates, the primary kernel's (T, 3, 256) pixel layout and
    the row-major unscramble."""
    from .trace_bvh import pack_pixels_np

    px, py, _ = block_pixel_order(width, height)
    cols, _r0 = pack_pixels_np(px, py)
    return px, py, cols, block_inverse16(width, height)


@lru_cache(maxsize=8)
def block_order(width: int, height: int, device: str):
    """(order, inverse) (R,) int64 on device for the 16x16-block pixel
    order: block-order ray i is row-major pixel order[i], and row_major
    = blocked[inverse]."""
    px, py, inverse = block_pixel_order(width, height)
    order = py.astype(np.int64) * width + px.astype(np.int64)
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(inverse, device=device))


def traced_in_blocks(trace_fn, width: int, height: int):
    """trace_fn(o, d, t_min, t_max) -> rows for the row-major rays of a
    whole width x height frame, traced in 16x16 pixel blocks: the flat
    kernels cull per 256-ray tile, and a tile of one block is far
    narrower than a 256x1 row strip. Both orders give the same rows."""
    def run(o, d, t_min, t_max):
        order, inverse = block_order(width, height, str(o.device))
        if isinstance(t_max, torch.Tensor) and t_max.dim() > 0:
            t_max = t_max[order]
        return trace_fn(o[order], d[order], t_min, t_max)[inverse]
    return run
