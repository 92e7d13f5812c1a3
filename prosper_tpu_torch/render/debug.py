"""Debug visualisation: draw-type AOVs, the TextureDebug viewer analog
and debug lines rasterised on the host.

Counterpart of prosper_tpu/render/debug.py:
- `DrawType` and `debug_color` (:27-86): the DrawType enum of the
  reference (DrawType.hpp:8-12) and commonDebugDraw's mapping
  (debug.glsl:17-38), ids as the pcg pastel hash colors of
  mathx/rng.uint_to_color;
- `dump_texture` (:87-115), TextureDebug's headless equivalent: any
  array (a tensor on either device, or numpy) written raw to .npy and,
  normalised over a channel and a range, to PNG (the CLI's
  --dump-debug);
- `DebugLines` (:118-180), DebugRenderer's line lists (at most 100k,
  DebugGeometry.hpp:13-20) projected with the camera and drawn over a
  frame in numpy.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from ..mathx.rng import uint_to_color


class DrawType(IntEnum):
    DEFAULT = 0
    PRIMITIVE_ID = 1
    MESHLET_ID = 2
    MESH_ID = 3
    MATERIAL_ID = 4
    POSITION = 5
    SHADING_NORMAL = 6
    TEXCOORD0 = 7
    ALBEDO = 8
    ROUGHNESS = 9
    METALLIC = 10


DRAW_TYPE_NAMES = [t.name.lower() for t in DrawType]


def debug_color(draw_type: DrawType, surface: dict, hit: dict,
                static: dict) -> torch.Tensor:
    """(R, 3) debug AOV of each pixel's surface; magenta for an unknown
    type."""
    tri = torch.clamp_min(hit["tri"], 0).long()
    meshlet = tri // 128
    shape = surface["albedo"].shape
    if draw_type == DrawType.PRIMITIVE_ID:
        return uint_to_color(tri)
    if draw_type == DrawType.MESHLET_ID:
        return uint_to_color(meshlet)
    if draw_type == DrawType.MESH_ID:
        return uint_to_color(static["wc_instance"][meshlet])
    if draw_type == DrawType.MATERIAL_ID:
        return uint_to_color(surface["material"])
    if draw_type == DrawType.POSITION:
        return surface["position_ws"]
    if draw_type == DrawType.SHADING_NORMAL:
        return surface["normal_ws"] * 0.5 + 0.5
    if draw_type == DrawType.TEXCOORD0:
        return torch.cat([surface["uv"], torch.zeros_like(surface["uv"][:, :1])],
                         dim=-1)
    if draw_type == DrawType.ALBEDO:
        return surface["albedo"]
    if draw_type == DrawType.ROUGHNESS:
        return surface["roughness"][:, None].expand(shape)
    if draw_type == DrawType.METALLIC:
        return surface["metallic"][:, None].expand(shape)
    magenta = surface["albedo"].new_zeros(3)
    magenta[0] = magenta[2] = 1.0
    return magenta.expand(shape)


# ---------------------------------------------------------------------------
# TextureDebug analog


def dump_texture(img, path: str, channel: str = "rgb",
                 lo: float | None = None, hi: float | None = None) -> None:
    """Write any intermediate array as path + ".npy" (raw) and as a PNG at
    path, normalised: channel "rgb" | "r" | "g" | "b" | "a" (TextureDebug's
    channel dropdown), lo/hi the range sliders (None: the array's min and
    max). img: a tensor on any device, or an array."""
    from ..io.image import write_npy, write_png

    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    a = np.asarray(img)
    write_npy(path + ".npy", a)
    if a.ndim == 2:
        a = a[..., None]
    idx = {"r": 0, "g": 1, "b": 2, "a": 3}
    if channel in idx:
        c = min(idx[channel], a.shape[-1] - 1)
        a = a[..., c : c + 1].repeat(3, axis=-1)
    else:
        if a.shape[-1] == 1:
            a = a.repeat(3, axis=-1)
        a = a[..., :3]
    lo = float(np.nanmin(a)) if lo is None else lo
    hi = float(np.nanmax(a)) if hi is None else hi
    scale = 1.0 / max(hi - lo, 1e-20)
    write_png(path, np.clip((a - lo) * scale, 0, 1))


# ---------------------------------------------------------------------------
# DebugRenderer analog: line lists drawn over the frame on the host

MAX_DEBUG_LINES = 100_000  # DebugGeometry.hpp:13-20


class DebugLines:
    """A frame's line list (addLine)."""

    def __init__(self) -> None:
        self.starts: list[np.ndarray] = []
        self.ends: list[np.ndarray] = []
        self.colors: list[np.ndarray] = []

    def add_line(self, p0, p1, color) -> None:
        if len(self.starts) >= MAX_DEBUG_LINES:
            return
        self.starts.append(np.asarray(p0, np.float32))
        self.ends.append(np.asarray(p1, np.float32))
        self.colors.append(np.asarray(color, np.float32))

    def add_frustum(self, corners: dict, color) -> None:
        """The frozen-frustum wireframe (App.cpp:1086-1156)."""
        for a, b in [
            ("bln", "brn"), ("brn", "trn"), ("trn", "tln"), ("tln", "bln"),
            ("blf", "brf"), ("brf", "trf"), ("trf", "tlf"), ("tlf", "blf"),
            ("bln", "blf"), ("brn", "brf"), ("trn", "trf"), ("tln", "tlf"),
        ]:
            self.add_line(corners[a], corners[b], color)

    def clear(self) -> None:
        self.starts, self.ends, self.colors = [], [], []

    def rasterize_over(self, img: np.ndarray, cam: dict) -> np.ndarray:
        """Project the lines with cam["world_to_clip"] and draw them over
        an (H, W, 3) image; returns a new array."""
        if not self.starts:
            return img
        img = np.array(img, copy=True)
        h, w = img.shape[:2]
        m = np.asarray(cam["world_to_clip"])

        def project(p):
            v = m @ np.append(p, 1.0)
            if v[3] <= 1e-6:
                return None
            ndc = v[:3] / v[3]
            return np.array([(ndc[0] * 0.5 + 0.5) * w,
                             (ndc[1] * 0.5 + 0.5) * h])

        for p0, p1, c in zip(self.starts, self.ends, self.colors):
            a, b = project(p0), project(p1)
            if a is None or b is None:
                continue
            n = int(max(np.abs(b - a).max(), 1))
            ts = np.linspace(0, 1, min(n + 1, 4096))
            pts = a[None] + (b - a)[None] * ts[:, None]
            xs = np.clip(pts[:, 0].astype(int), 0, w - 1)
            ys = np.clip(pts[:, 1].astype(int), 0, h - 1)
            img[ys, xs] = c
        return img
