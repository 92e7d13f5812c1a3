"""Camera uniforms of each frame, from an eye, a target and a path.

A frozen copy, as it stood at commit e89c417, of the camera of
`prosper_tpu_torch.scene.camera.Camera` (right-handed lookAt, reverse-z
glTF projection, no TAA jitter; `uniforms()`), of the transforms it calls
(`prosper_tpu_torch.mathx.transforms`: look_at, perspective_reverse_z,
frustum_corners, frustum_planes). Both the program and the reference
take the uniforms made here.

Paths: "static" keeps the camera where the scene puts it; {"kind":
"orbit", "deg_per_frame": d} turns the eye about the vertical axis
through the target, at the scene's eye distance and height, through
360 / d positions, position 0 being the scene's eye. Each position's
prev_world_to_clip is the previous position's world_to_clip, position
n - 1's for position 0, so the cycle closes.
"""

from __future__ import annotations

import numpy as np

FOV_Y = float(np.radians(59.0))
Z_NEAR = 0.1
Z_FAR = 100.0
SENSOR_WIDTH = 0.035
APERTURE = 0.00001
FOCUS_DISTANCE = 1.0
UP = np.array([0.0, 1.0, 0.0], np.float32)


def look_at(eye, target, up) -> np.ndarray:
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


def perspective_reverse_z(fov_y, aspect, z_near, z_far) -> np.ndarray:
    zn, zf = z_far, z_near
    tf = 1.0 / np.tan(fov_y * 0.5)
    proj = np.array(
        [
            [tf / aspect, 0.0, 0.0, 0.0],
            [0.0, tf, 0.0, 0.0],
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


def _plane(p0, p1, p2) -> np.ndarray:
    n = np.cross(p1 - p0, p2 - p0)
    n = n / np.linalg.norm(n)
    return np.concatenate([n, [-np.dot(n, p0)]]).astype(np.float32)


def _frustum_planes(eye, w2c, aspect) -> np.ndarray:
    right, up, fwd = w2c[0, :3], w2c[1, :3], -w2c[2, :3]
    hy_f = Z_FAR * np.tan(FOV_Y * 0.5)
    hy_n = Z_NEAR * np.tan(FOV_Y * 0.5)
    eye = np.asarray(eye, np.float32)

    hx_f, hx_n = hy_f * aspect, hy_n * aspect

    def corner(z, hx, hy, sx, sy):
        return eye + z * fwd + sx * hx * right + sy * hy * up

    n, f = (Z_NEAR, hx_n, hy_n), (Z_FAR, hx_f, hy_f)
    c = {"bln": corner(*n, -1, -1), "brn": corner(*n, 1, -1),
         "tln": corner(*n, -1, 1), "trn": corner(*n, 1, 1),
         "blf": corner(*f, -1, -1), "brf": corner(*f, 1, -1),
         "tlf": corner(*f, -1, 1), "trf": corner(*f, 1, 1)}
    return np.stack([
        _plane(c["brn"], c["bln"], c["trn"]),
        _plane(c["brf"], c["trf"], c["blf"]),
        _plane(c["bln"], c["blf"], c["tln"]),
        _plane(c["brn"], c["trn"], c["brf"]),
        _plane(c["tln"], c["tlf"], c["trn"]),
        _plane(c["bln"], c["brn"], c["blf"]),
    ])


def uniforms(eye, target, width: int, height: int) -> dict:
    """The camera uniforms dict the renderer's frame call takes (the keys
    and values of Camera.uniforms() without jitter) of a camera that
    stays where it is: its previous world_to_clip is its own."""
    aspect = width / height
    w2c = look_at(eye, target, UP)
    c2c = perspective_reverse_z(FOV_Y, aspect, Z_NEAR, Z_FAR)
    w2clip = c2c @ w2c
    tf = 1.0 / np.tan(FOV_Y * 0.5)
    zero2 = np.zeros(2, np.float32)
    return {
        "world_to_camera": w2c,
        "camera_to_world": np.linalg.inv(w2c),
        "camera_to_clip": c2c,
        "clip_to_world": np.linalg.inv(w2clip),
        "world_to_clip": w2clip,
        "prev_world_to_clip": w2clip,
        "eye": np.asarray(eye, np.float32),
        "frustum_planes": _frustum_planes(eye, w2c, aspect),
        "resolution": np.array([width, height], np.int32),
        "current_jitter": zero2,
        "previous_jitter": zero2.copy(),
        "near": np.float32(Z_NEAR),
        "far": np.float32(Z_FAR),
        "max_view_scale": np.float32(np.max(np.linalg.norm(w2c[:3, :3], axis=0))),
        "aperture_diameter": np.float32(APERTURE),
        "focus_distance": np.float32(FOCUS_DISTANCE),
        "focal_length": np.float32((SENSOR_WIDTH / aspect) * tf * 0.5),
    }


def orbit_eyes(eye, target, deg_per_frame: float) -> np.ndarray:
    """The eyes of an orbit: (n, 3) float32, n = 360 / deg_per_frame (a
    whole number), eye k turned by k * deg_per_frame degrees about the
    vertical axis through the target (counter-clockwise seen from
    above)."""
    d = float(deg_per_frame)
    n = int(round(360.0 / d)) if d > 0 else 0
    if n < 2 or abs(n * d - 360.0) > 1e-9 * 360.0:
        raise ValueError(f"deg_per_frame {d!r} does not divide 360 into "
                         f"two or more positions")
    off = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
    a = np.radians(d * np.arange(n))
    c, s = np.cos(a), np.sin(a)
    eyes = np.stack([off[0] * c + off[2] * s, np.full(n, off[1]),
                     -off[0] * s + off[2] * c], 1) + np.asarray(target,
                                                               np.float64)
    return eyes.astype(np.float32)


def camera_path(path: dict, eye, target, width: int, height: int) -> list:
    """The distinct uniforms a camera path cycles through: one for
    "static", 360 / d for "orbit" (frame i takes position i % n)."""
    kind = path.get("kind", "static")
    if kind == "static":
        return [uniforms(eye, target, width, height)]
    if kind == "orbit":
        cams = [uniforms(e, target, width, height)
                for e in orbit_eyes(eye, target, path["deg_per_frame"])]
        for k, cam in enumerate(cams):
            cam["prev_world_to_clip"] = cams[k - 1]["world_to_clip"].copy()
        return cams
    raise ValueError(f"unknown camera path {kind!r}")
