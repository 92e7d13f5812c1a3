"""Camera uniforms in numpy.

Counterpart of prosper_tpu/scene/camera.py (`Camera`, `look_at`,
`end_frame`, `uniforms`) over the port's copy of mathx/transforms.py. A copy, because
the JAX package's camera module imports jax through mathx.

Right-handed lookAt, reverse-z glTF projection with the Halton(2,3) TAA
jitter folded into the matrix (Camera.cpp:105-153 of the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mathx.transforms import (
    frustum_corners,
    frustum_planes,
    look_at,
    perspective_reverse_z,
)

SENSOR_WIDTH = 0.035  # 35 mm film back (Camera.hpp sensorWidth)

# Halton base-2/base-3 subpixel jitter (Camera.cpp:22-36)
HALTON_23 = np.array(
    [
        [0.5, 0.3333333333333333],
        [0.25, 0.6666666666666666],
        [0.75, 0.1111111111111111],
        [0.125, 0.4444444444444444],
        [0.625, 0.7777777777777778],
        [0.375, 0.2222222222222222],
        [0.875, 0.5555555555555556],
        [0.0625, 0.8888888888888888],
    ],
    dtype=np.float32,
)


@dataclass
class CameraParameters:
    fov: float = float(np.radians(59.0))
    z_near: float = 0.1
    z_far: float = 100.0
    aperture_diameter: float = 0.00001
    focus_distance: float = 1.0
    focal_length: float = 0.0


@dataclass
class CameraTransform:
    eye: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.5, 1.0], np.float32)
    )
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )


class Camera:
    """A camera at one resolution; `uniforms()` is the per-frame
    CameraUniforms dict (shader_structs/scene/camera.h:12-34)."""

    def __init__(self, resolution, parameters=None, transform=None,
                 apply_jitter: bool = False) -> None:
        self.resolution = resolution  # (width, height)
        self.parameters = parameters or CameraParameters()
        self.transform = transform or CameraTransform()
        self.apply_jitter = apply_jitter
        self._jitter_index = 0
        self._current_jitter = np.zeros(2, np.float32)
        self._previous_jitter = np.zeros(2, np.float32)
        self._prev_world_to_camera = None
        self._prev_camera_to_clip = None
        self.update()

    def look_at(self, transform: CameraTransform) -> None:
        """Aim the camera (World.make_camera's scene camera)."""
        self.transform = transform
        self.update()

    def update(self) -> None:
        """Recompute matrices for the current frame (Camera::updateBuffer)."""
        w, h = self.resolution
        ar = w / h
        p = self.parameters
        if self.apply_jitter:
            j = HALTON_23[self._jitter_index] * 2.0 - 1.0
            self._current_jitter = (j / np.array([w, h], np.float32)).astype(
                np.float32
            )
        else:
            self._current_jitter = np.zeros(2, np.float32)
        self._world_to_camera = look_at(
            self.transform.eye, self.transform.target, self.transform.up
        )
        self._camera_to_clip = perspective_reverse_z(
            p.fov, ar, p.z_near, p.z_far, tuple(self._current_jitter)
        )
        tf = 1.0 / np.tan(p.fov * 0.5)
        p.focal_length = (SENSOR_WIDTH / ar) * tf * 0.5
        if self._prev_world_to_camera is None:
            self._prev_world_to_camera = self._world_to_camera.copy()
            self._prev_camera_to_clip = self._camera_to_clip.copy()

    def end_frame(self) -> None:
        """Rotate the previous-frame state (Camera::endFrame): this
        frame's matrices and jitter become the previous ones, and the
        Halton index advances (the next update() takes its jitter)."""
        self._prev_world_to_camera = self._world_to_camera.copy()
        self._prev_camera_to_clip = self._camera_to_clip.copy()
        self._previous_jitter = self._current_jitter.copy()
        self._jitter_index = (self._jitter_index + 1) % len(HALTON_23)

    def uniforms(self) -> dict[str, np.ndarray]:
        """CameraUniforms dict, the same keys and values as the JAX
        package's Camera.uniforms."""
        p = self.parameters
        w, h = self.resolution
        world_to_clip = self._camera_to_clip @ self._world_to_camera
        prev_world_to_clip = self._prev_camera_to_clip @ self._prev_world_to_camera
        corners = frustum_corners(
            self.transform.eye, self._world_to_camera, p.fov, w / h,
            p.z_near, p.z_far,
        )
        col_scales = np.linalg.norm(self._world_to_camera[:3, :3], axis=0)
        return {
            "world_to_camera": self._world_to_camera,
            "camera_to_world": np.linalg.inv(self._world_to_camera),
            "camera_to_clip": self._camera_to_clip,
            "clip_to_world": np.linalg.inv(world_to_clip),
            "world_to_clip": world_to_clip,
            "prev_world_to_clip": prev_world_to_clip,
            "eye": np.asarray(self.transform.eye, np.float32),
            "frustum_planes": frustum_planes(corners).astype(np.float32),
            "resolution": np.array([w, h], np.int32),
            "current_jitter": self._current_jitter,
            "previous_jitter": self._previous_jitter,
            "near": np.float32(p.z_near),
            "far": np.float32(p.z_far),
            "max_view_scale": np.float32(np.max(col_scales)),
            "aperture_diameter": np.float32(p.aperture_diameter),
            "focus_distance": np.float32(p.focus_distance),
            "focal_length": np.float32(p.focal_length),
        }
