"""A copy of prosper_tpu/scene/animation.py (numpy), kept in the port so that it
imports nothing of the JAX package.

Animation evaluation with reference semantics.

Mirrors the reference's src/scene/Animations.hpp:70-120 and
Accessors.cpp:25-75:
- clamp before first / after last keyframe (t=0 at the boundary frames)
- Step: first value
- Linear: lerp, slerp for rotations
- CubicSpline: Hermite basis; NOTE the reference feeds `td` as the elapsed
  time within the interval (timeS - firstTime, Accessors.cpp:67), not the
  keyframe interval length the glTF spec prescribes. We reproduce that
  behavior for parity ("stepDuration" quirk).
- CubicSpline rotations are normalized after interpolation.

Host-side numpy; per-frame animation targets are tiny (the reference runs
this on the CPU each frame too, App.cpp:511-524).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gltf import GltfAnimationChannel


def _slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(a, b))
    if d < 0.0:
        b = -b
        d = -d
    if d > 0.9995:
        out = a + t * (b - a)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) / s) * a + (np.sin(t * theta) / s) * b


@dataclass
class _Interp:
    t: float
    first: int
    step_duration: float


def _lookup(times: np.ndarray, time_s: float) -> _Interp:
    """Keyframe interval lookup (Accessors.cpp:25-75)."""
    n = len(times)
    if time_s <= times[0]:
        return _Interp(0.0, 0, 0.0)
    if time_s >= times[-1]:
        return _Interp(0.0, n - 1, 0.0)
    first = int(np.searchsorted(times, time_s, side="right")) - 1
    first = min(first, n - 2)
    duration = float(times[first + 1] - times[first])
    step_duration = float(time_s - times[first])
    t = step_duration / duration if duration > 0 else 0.0
    return _Interp(t, first, step_duration)


def sample_channel(ch: GltfAnimationChannel, time_s: float) -> np.ndarray:
    """Evaluate one channel at time_s -> (C,) value."""
    interp = _lookup(ch.times, time_s)
    is_rot = ch.path == "rotation"
    cubic = ch.interpolation == "CUBICSPLINE"

    if interp.t == 0.0:
        if cubic:
            return ch.values[interp.first * 3 + 1].copy()
        return ch.values[interp.first].copy()

    if ch.interpolation == "STEP":
        return ch.values[interp.first].copy()

    if ch.interpolation == "LINEAR":
        v0 = ch.values[interp.first]
        v1 = ch.values[interp.first + 1]
        if is_rot:
            return _slerp(v0, v1, interp.t)
        return (1.0 - interp.t) * v0 + interp.t * v1

    # CUBICSPLINE (Animations.hpp:95-117)
    i0 = interp.first * 3
    vk = ch.values[i0 + 1]
    bk = ch.values[i0 + 2]
    ak1 = ch.values[i0 + 3]
    vk1 = ch.values[i0 + 3 + 1]
    t = interp.t
    t2, t3 = t * t, t * t * t
    td = interp.step_duration  # reference quirk, see module docstring
    value = (
        (2 * t3 - 3 * t2 + 1.0) * vk
        + td * (t3 - 2 * t2 + t) * bk
        + (-2 * t3 + 3 * t2) * vk1
        + td * (t3 - t2) * ak1
    )
    if is_rot:
        value = value / np.linalg.norm(value)
    return value


def animations_end_time(channels: list[GltfAnimationChannel]) -> float:
    return max((float(c.times[-1]) for c in channels), default=0.0)


def update_animations(
    channels: list[GltfAnimationChannel], time_s: float
) -> dict[tuple[int, str], np.ndarray]:
    """Evaluate all channels -> {(node, path): value} (World::updateAnimations)."""
    return {(c.node, c.path): sample_channel(c, time_s) for c in channels}
