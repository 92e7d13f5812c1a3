"""A copy of prosper_tpu/mathx/transforms.py (numpy), kept in the port so that it
imports nothing of the JAX package.

Host-side transform math (numpy): TRS composition, camera matrices,
frustum planes — parity with the reference's glm usage.

References:
- lookAt / worldToCamera: the reference's src/scene/Camera.cpp:366-395
  (right-handed, z = -fwd)
- reverse-z glTF projection with jitter in the 3rd column and the
  [-1,1]->[0,1] z remap + y flip premultiply:
  the reference's src/scene/Camera.cpp:105-153
- frustum corner/plane construction: Camera.cpp:268-313, 398-415
- node TRS composition: the reference's src/scene/World.cpp:359-466
  (translate * rotate * scale, 3x4 modelToWorld + normalToWorld)

All matrices here are row-major numpy acting on column vectors
(M @ v), matching glm's math (glm stores column-major; the values are the
same linear maps).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Quaternions / TRS


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3) rotation (glTF order)."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-30), 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    m = np.empty(q.shape[:-1] + (3, 3), np.float32)
    m[..., 0, 0] = 1.0 - (yy + zz)
    m[..., 0, 1] = xy - wz
    m[..., 0, 2] = xz + wy
    m[..., 1, 0] = xy + wz
    m[..., 1, 1] = 1.0 - (xx + zz)
    m[..., 1, 2] = yz - wx
    m[..., 2, 0] = xz - wy
    m[..., 2, 1] = yz + wx
    m[..., 2, 2] = 1.0 - (xx + yy)
    return m


def trs_to_mat4(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """translate * rotate * scale -> 4x4 (World.cpp updateScene semantics)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_mat3(r) * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


def normal_matrix(model_to_world: np.ndarray) -> np.ndarray:
    """normalToWorld = transpose(inverse(modelToWorld)) upper 3x3, stored 4x4."""
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = np.linalg.inv(model_to_world[:3, :3]).T
    return out


def mat4_to_3x4(m: np.ndarray) -> np.ndarray:
    """Store as 3x4 rows like the reference's ModelInstanceTransforms
    (shader_structs scene/model_instance_transforms: 2x mat3x4)."""
    return m[:3, :4].astype(np.float32)


# ---------------------------------------------------------------------------
# Camera


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed worldToCamera (Camera.cpp:366-383)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    right = np.cross(up, z)
    right = right / np.linalg.norm(right)
    new_up = np.cross(z, right)
    new_up = new_up / np.linalg.norm(new_up)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = new_up
    m[2, :3] = z
    m[0, 3] = -np.dot(right, eye)
    m[1, 3] = -np.dot(new_up, eye)
    m[2, 3] = -np.dot(z, eye)
    return m


def perspective_reverse_z(
    fov_y: float,
    aspect: float,
    z_near: float,
    z_far: float,
    jitter: tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """cameraToClip: reverse-z glTF projection, z in [0,1], y flipped,
    subpixel jitter baked into the 3rd column (Camera.cpp:105-146).

    `jitter` is the NDC-units Halton jitter (already scaled by 2/resolution).
    """
    # Reverse-z swap (Camera.cpp:113-115)
    zn, zf = z_far, z_near
    tf = 1.0 / np.tan(fov_y * 0.5)
    jx, jy = jitter
    # glm mat4{...} in Camera.cpp is column-major; rows below are the
    # row-major equivalent of the same linear map.
    proj = np.array(
        [
            [tf / aspect, 0.0, -jx, 0.0],
            [0.0, tf, jy, 0.0],
            [0.0, 0.0, (zf + zn) / (zn - zf), 2.0 * zf * zn / (zn - zf)],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=np.float32,
    )
    remap = np.array(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, -1.0, 0.0, 0.0],
            [0.0, 0.0, 0.5, 0.5],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return remap @ proj


def get_plane(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Plane (normal, d) through 3 points (Camera.cpp:38-44)."""
    n = np.cross(p1 - p0, p2 - p0)
    n = n / np.linalg.norm(n)
    return np.concatenate([n, [-np.dot(n, p0)]]).astype(np.float32)


def frustum_corners(
    eye: np.ndarray,
    world_to_camera: np.ndarray,
    fov_y: float,
    aspect: float,
    z_near: float,
    z_far: float,
) -> dict[str, np.ndarray]:
    """World-space frustum corners (Camera.cpp:268-313)."""
    right = world_to_camera[0, :3]
    up = world_to_camera[1, :3]
    fwd = -world_to_camera[2, :3]
    half_y_far = z_far * np.tan(fov_y * 0.5)
    half_x_far = half_y_far * aspect
    half_y_near = z_near * np.tan(fov_y * 0.5)
    half_x_near = half_y_near * aspect
    eye = np.asarray(eye, np.float32)

    def corner(z, hx, hy, sx, sy):
        return eye + z * fwd + sx * hx * right + sy * hy * up

    return {
        "bln": corner(z_near, half_x_near, half_y_near, -1, -1),
        "brn": corner(z_near, half_x_near, half_y_near, +1, -1),
        "tln": corner(z_near, half_x_near, half_y_near, -1, +1),
        "trn": corner(z_near, half_x_near, half_y_near, +1, +1),
        "blf": corner(z_far, half_x_far, half_y_far, -1, -1),
        "brf": corner(z_far, half_x_far, half_y_far, +1, -1),
        "tlf": corner(z_far, half_x_far, half_y_far, -1, +1),
        "trf": corner(z_far, half_x_far, half_y_far, +1, +1),
    }


def frustum_planes(c: dict[str, np.ndarray]) -> np.ndarray:
    """6 world-space planes (near, far, left, right, top, bottom), shape (6,4),
    inward-facing normals (Camera.cpp:398-415)."""
    return np.stack(
        [
            get_plane(c["brn"], c["bln"], c["trn"]),
            get_plane(c["brf"], c["trf"], c["blf"]),
            get_plane(c["bln"], c["blf"], c["tln"]),
            get_plane(c["brn"], c["trn"], c["brf"]),
            get_plane(c["tln"], c["tlf"], c["trn"]),
            get_plane(c["bln"], c["brn"], c["blf"]),
        ]
    )
