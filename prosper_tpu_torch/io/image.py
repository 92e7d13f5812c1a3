"""Image file IO through PIL, imported where it is used.

Counterpart of prosper_tpu/io/image.py `load_image_rgba8`, `write_png`
and `write_npy`: the stb-load analog of the reference's texture path and
the headless frame output.
"""

from __future__ import annotations

import numpy as np


def load_image_rgba8(path: str) -> np.ndarray:
    """Load a PNG or JPEG as (H, W, 4) uint8 (stb with STBI_rgb_alpha)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def write_png(path: str, img) -> None:
    """Write (H, W, 3|4) uint8, or float in [0, 1], to a PNG."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(img).save(path)


def write_npy(path: str, img) -> None:
    """Raw array dump (the TextureDebug equivalent)."""
    np.save(path, np.asarray(img))
