"""Frame-late readbacks: one texel of an image, and the draw stats.

Counterpart of prosper_tpu/render/readback.py (`TextureReadback`,
`focus_from_depth`, `pick_focus_distance`, `DrawStats`),
TextureReadback.* and the draw-stat readback of the reference
(App.cpp:583-631, Renderer.cpp:371-401): a value is queued in one frame
and polled a frame or two later, so the frame that queued it never
waits for the card.
"""

from __future__ import annotations

import torch

from ..utils.profiler import gprofiler


def _texel(shape, uv) -> tuple[int, int]:
    h, w = shape[:2]
    return min(int(uv[1] * h), h - 1), min(int(uv[0] * w), w - 1)


class TextureReadback:
    """Queue a one-texel read this frame, poll it later. On the card the
    texel is copied into pinned host memory with non_blocking=True behind
    a CUDA event; poll waits for that event alone."""

    def __init__(self) -> None:
        self._pending = None

    def queue(self, image: torch.Tensor, uv) -> None:
        y, x = _texel(image.shape, uv)
        texel = image[y, x]
        if image.device.type == "cuda":
            host = torch.empty(texel.shape, dtype=texel.dtype,
                               pin_memory=True)
            host.copy_(texel, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pending = (host, done)
        else:
            self._pending = (texel.clone(), None)

    def poll(self):
        """The queued value as a numpy array, or None when nothing is
        queued (the startFrame/poll protocol)."""
        if self._pending is None:
            return None
        host, done = self._pending
        if done is not None:
            with gprofiler.wait("readback.poll"):
                done.synchronize()
        self._pending = None
        return host.numpy()


def focus_from_depth(d: float, cam: dict) -> float:
    """A picked reverse-z depth -> focusDistance (linearizeDepth,
    scene/camera.glsl:11-22)."""
    c2c = cam["camera_to_clip"]
    lin = -float(c2c[2, 3]) / (d + float(c2c[2, 2]))
    return max(-lin, float(cam["near"]))


def pick_focus_distance(depth: torch.Tensor, cam: dict, uv) -> float:
    """Depth picking -> focusDistance, waiting for the value (tests; a
    frame loop queues a TextureReadback and converts with
    focus_from_depth a frame later)."""
    y, x = _texel(depth.shape, uv)
    return focus_from_depth(float(depth[y, x]), cam)


class DrawStats:
    """Frame-late draw-stat counters (drawn meshlets, rasterized
    triangles)."""

    def __init__(self) -> None:
        self._pending: dict | None = None

    def record(self, stats: dict) -> None:
        self._pending = dict(stats)

    def poll(self) -> dict | None:
        if self._pending is None:
            return None
        out = {k: int(v) for k, v in self._pending.items()}
        self._pending = None
        return out
