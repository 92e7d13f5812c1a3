"""World texture storage: one flat arena of bilinear quads with mips.

A copy of prosper_tpu/scene/textures.py (:28-237, numpy): the reference
binds a variable-count descriptor array of BC7 textures
(WorldData.cpp:1758-1776); here all mips of all textures live in ONE
flat (N, 4) uint32 arena of bilinear quads (RGBA8 per texel, a texel and
its +x, +y, +xy REPEAT neighbours, so a bilinear tap is one row gather)
addressed through a (texture, mip) table of (offset, width, height,
flags), flags bit 0 = sRGB, bits 1-2 / 3-4 = u / v wrap. Slot 0 is the
neutral 1 px default texture (WorldData.cpp:726-755). Mip chains are a
2x2 box filter in linear space (Texture.cpp:166-298 generates them on the
CPU; the BC7 encode is replaced by packed RGBA8). ops/texture.py samples
the arena.

The streaming arena (`build_streaming_arena`, :269-352) has the same
layout, taken from the image headers, with every texture's rows filled
by its neutral color; its jobs decode and mip one image each on the
loading worker (scene/streaming.py), and `arena_write` writes a finished
chunk over its rows of the arena tensor on the device.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..io.image import load_image_rgba8
from .gltf import GltfDocument

MAX_MIPS = 13  # up to 4096^2


def _srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb_np(x: np.ndarray) -> np.ndarray:
    y = np.where(x <= 0.0031308, x * 12.92, 1.055 * np.maximum(x, 1e-12) ** (1 / 2.4) - 0.055)
    return np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)


def generate_mips(img: np.ndarray, srgb: bool) -> list[np.ndarray]:
    """Full mip chain by 2x2 box filter in linear space (alpha linear)."""
    mips = [img]
    cur = img
    if srgb:
        lin = np.concatenate(
            [_srgb_to_linear_np(cur[..., :3]), cur[..., 3:].astype(np.float32) / 255.0],
            axis=-1,
        )
    else:
        lin = cur.astype(np.float32) / 255.0
    while min(lin.shape[0], lin.shape[1]) > 1:
        h, w = lin.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        lin = lin[: nh * 2, : nw * 2]
        lin = (
            lin.reshape(nh, 2, nw, 2, 4).mean(axis=(1, 3))
            if h > 1 and w > 1
            else lin.reshape(nh, -1, nw, 1, 4).mean(axis=(1, 3))
        )
        if srgb:
            m8 = np.concatenate(
                [
                    _linear_to_srgb_np(lin[..., :3]),
                    np.clip(lin[..., 3:] * 255.0 + 0.5, 0, 255).astype(np.uint8),
                ],
                axis=-1,
            )
        else:
            m8 = np.clip(lin * 255.0 + 0.5, 0, 255).astype(np.uint8)
        mips.append(m8)
    return mips


def pack_rgba8(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) u8 -> (H*W,) u32 (R in low byte)."""
    i = img.astype(np.uint32)
    return (
        i[..., 0] | (i[..., 1] << 8) | (i[..., 2] << 16) | (i[..., 3] << 24)
    ).reshape(-1)


def pack_rgba8_quads(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) u8 -> (H*W, 4) u32 bilinear quads with REPEAT wrap.

    Quad i = y*W + x stores texels (x,y), (x+1,y), (x,y+1), (x+1,y+1)
    (wrapped), so a bilinear fetch is ONE 16-byte row gather instead of
    four scattered texel gathers — XLA gathers whole minor rows fast,
    single elements slowly. 4x memory for ~4x fewer gathers.
    """
    flat = pack_rgba8(img)
    h, w = img.shape[:2]
    grid = flat.reshape(h, w)
    xr = np.roll(grid, -1, axis=1)
    yr = np.roll(grid, -1, axis=0)
    xyr = np.roll(xr, -1, axis=0)
    return np.stack(
        [grid.reshape(-1), xr.reshape(-1), yr.reshape(-1), xyr.reshape(-1)],
        axis=1,
    )


@dataclass
class TextureArena:
    data: np.ndarray  # (N, 4) u32 bilinear-quad arena
    # table[t, m] = (offset, width, height, flags) ; flags bit0 = srgb
    table: np.ndarray  # (T, MAX_MIPS, 4) i32
    n_mips: np.ndarray  # (T,) i32

    def uniforms(self) -> dict[str, np.ndarray]:
        return {"data": self.data, "table": self.table, "n_mips": self.n_mips}


def decode_image(doc: GltfDocument, index: int, max_dim: int | None,
                 neutral_rgba=None) -> np.ndarray:
    """Decode one scene image to RGBA8 (stb-load analog), with the
    missing-file neutral fallback."""
    import os

    img_spec = doc.images[index]
    if img_spec.uri is not None:
        path = os.path.join(doc.base_dir, img_spec.uri)
        if os.path.exists(path):
            img = load_image_rgba8(path)
        else:
            img = neutral_rgba
    elif img_spec.data is not None:
        from PIL import Image

        with Image.open(io.BytesIO(img_spec.data)) as im:
            img = np.asarray(im.convert("RGBA"), np.uint8)
    else:
        img = neutral_rgba
    if img is None:
        img = np.full((1, 1, 4), 255, np.uint8)
    if max_dim is not None and max(img.shape[:2]) > max_dim:
        from PIL import Image

        h, w = img.shape[:2]
        scale = max_dim / max(h, w)
        im = Image.fromarray(img).resize(
            (max(int(w * scale), 1), max(int(h * scale), 1)), Image.LANCZOS
        )
        img = np.asarray(im, np.uint8)
    return img


def image_mips_cached(
    doc: GltfDocument,
    index: int,
    max_dim: int | None,
    srgb: bool,
    neutral_rgba,
    scene_path: str | None = None,
) -> list[np.ndarray]:
    """Decode + mip one image through the versioned texture cache
    (Texture2D::init's DDS-cache flow; codec swapped to RGBA8 mips).
    Returns the (H, W, 4) u8 mip chain."""
    from .caches import load_texture_cache, save_texture_cache, texture_cache_path

    cpath = None
    uri = doc.images[index].uri
    if scene_path and uri:
        cpath = texture_cache_path(scene_path, uri, max_dim)
    if cpath:
        cached = load_texture_cache(cpath)
        if cached is not None and cached[1] == srgb:
            return cached[0]
    img = decode_image(doc, index, max_dim, neutral_rgba)
    mips = generate_mips(img, srgb)[:MAX_MIPS]
    if cpath:
        try:
            save_texture_cache(cpath, mips, srgb)
        except OSError:
            pass
    return mips


def neutral_image(doc: GltfDocument, index: int) -> np.ndarray:
    """Missing-file fallback: flat normal for normal maps, white else."""
    normal_images = {
        m.normal_texture.image for m in doc.materials if m.normal_texture.image >= 0
    }
    if index in normal_images:
        return np.array([[[128, 128, 255, 255]]], np.uint8)
    return np.full((1, 1, 4), 255, np.uint8)


def build_texture_arena(
    doc: GltfDocument,
    max_dim: int | None = None,
    scene_path: str | None = None,
) -> TextureArena:
    """Decode all scene images, mip them, pack into the flat quad arena.

    Slot 0: 1px white default. Image i -> slot i+1 (material tables already
    use the +1 convention). With scene_path, mips go through the
    versioned texture cache.
    """
    color_spaces = doc.image_color_spaces()
    wrap_modes = doc.image_wrap_modes()
    chunks: list[np.ndarray] = []
    n_tex = len(doc.images) + 1
    table = np.zeros((n_tex, MAX_MIPS, 4), np.int32)
    n_mips = np.zeros(n_tex, np.int32)
    offset = 0

    def add_mips(
        slot: int, mips: list[np.ndarray], srgb: bool, wrap=(0, 0)
    ) -> None:
        # flags: bit0 srgb, bits1-2 wrap_u, bits3-4 wrap_v (ops/texture)
        flags = (1 if srgb else 0) | (wrap[0] << 1) | (wrap[1] << 3)
        nonlocal offset
        n_mips[slot] = len(mips)
        for m, mip in enumerate(mips):
            h, w = mip.shape[:2]
            table[slot, m] = (offset, w, h, flags)
            chunks.append(pack_rgba8_quads(mip))
            offset += h * w
        # clamp table tail to last mip for out-of-range lods
        for m in range(len(mips), MAX_MIPS):
            table[slot, m] = table[slot, len(mips) - 1]

    # default: 1px white, linear
    add_mips(0, [np.full((1, 1, 4), 255, np.uint8)], srgb=False)

    for i in range(len(doc.images)):
        srgb = color_spaces[i] == "srgb"
        mips = image_mips_cached(
            doc, i, max_dim, srgb, neutral_image(doc, i), scene_path
        )
        add_mips(i + 1, mips, srgb, wrap_modes[i])

    return TextureArena(
        data=np.concatenate(chunks).astype(np.uint32),
        table=table,
        n_mips=n_mips,
    )


def image_dims(doc: GltfDocument, index: int, max_dim: int | None):
    """(h, w) that an image decodes to, read from its header (PIL) with
    decode_image's max_dim rescale; a missing or unreadable file gives
    the 1 px neutral."""
    import os

    from PIL import Image, UnidentifiedImageError

    img_spec = doc.images[index]
    try:
        if img_spec.uri is not None:
            path = os.path.join(doc.base_dir, img_spec.uri)
            if not os.path.exists(path):
                return 1, 1
            with Image.open(path) as im:
                w, h = im.size
        elif img_spec.data is not None:
            with Image.open(io.BytesIO(img_spec.data)) as im:
                w, h = im.size
        else:
            return 1, 1
    except (OSError, UnidentifiedImageError):
        return 1, 1
    if max_dim is not None and max(w, h) > max_dim:
        scale = max_dim / max(h, w)
        w, h = max(int(w * scale), 1), max(int(h * scale), 1)
    return h, w


def _predicted_mip_dims(h: int, w: int) -> list[tuple[int, int]]:
    """The mip dims generate_mips produces (halving until the smaller
    side reaches 1), at most MAX_MIPS."""
    dims = [(h, w)]
    while min(h, w) > 1 and len(dims) < MAX_MIPS:
        h, w = max(h // 2, 1), max(w // 2, 1)
        dims.append((h, w))
    return dims


def build_streaming_arena(
    doc: GltfDocument,
    max_dim: int | None = None,
    scene_path: str | None = None,
):
    """The streaming texture arena: build_texture_arena's layout from the
    image headers, each texture's rows filled with its neutral color.
    Returns (arena, jobs): each job decodes and mips one image (on the
    loading worker) and returns a LoadedTexture whose packed quads
    arena_write puts over the neutral rows (DeferredLoadingContext::
    loadNextTexture and its per-frame adoption,
    DeferredLoadingContext.cpp:929-1029)."""
    from .streaming import LoadedTexture

    color_spaces = doc.image_color_spaces()
    wrap_modes = doc.image_wrap_modes()
    n_tex = len(doc.images) + 1
    table = np.zeros((n_tex, MAX_MIPS, 4), np.int32)
    n_mips = np.zeros(n_tex, np.int32)

    offset = 0
    spans: list[tuple[int, int, np.ndarray]] = []  # (offset, rows, fill)

    def layout(slot: int, h: int, w: int, srgb: bool, fill_rgba: np.ndarray,
               wrap=(0, 0)):
        flags = (1 if srgb else 0) | (wrap[0] << 1) | (wrap[1] << 3)
        nonlocal offset
        dims = _predicted_mip_dims(h, w)
        n_mips[slot] = len(dims)
        start = offset
        for m, (mh, mw) in enumerate(dims):
            table[slot, m] = (offset, mw, mh, flags)
            offset += mh * mw
        for m in range(len(dims), MAX_MIPS):
            table[slot, m] = table[slot, len(dims) - 1]
        fill = pack_rgba8(fill_rgba.reshape(1, 1, 4))[0]
        spans.append((start, offset - start, fill))
        return start

    layout(0, 1, 1, False, np.full(4, 255, np.uint8))
    starts = []
    for i in range(len(doc.images)):
        h, w = image_dims(doc, i, max_dim)
        starts.append(layout(i + 1, h, w, color_spaces[i] == "srgb",
                             neutral_image(doc, i)[0, 0], wrap_modes[i]))

    data = np.empty((offset, 4), np.uint32)
    for start, rows, fill in spans:
        data[start : start + rows] = fill
    # the default slot holds its real (white) content from the start
    data[0:1] = pack_rgba8_quads(np.full((1, 1, 4), 255, np.uint8))

    def make_job(i: int, start: int):
        def job():
            mips = image_mips_cached(doc, i, max_dim,
                                     color_spaces[i] == "srgb",
                                     neutral_image(doc, i), scene_path)
            chunk = np.concatenate(
                [pack_rgba8_quads(m) for m in mips]).astype(np.uint32)
            return LoadedTexture(image_index=i, offset=start, chunk=chunk)

        return job

    jobs = [make_job(i, starts[i]) for i in range(len(doc.images))]
    return TextureArena(data=data, table=table, n_mips=n_mips), jobs


def arena_write(data, chunk: np.ndarray, offset: int):
    """Adopt a streamed texture: write its packed quads (rows, 4) u32
    over rows [offset, offset + rows) of the arena tensor `data` (the u32
    words widened to int64, as scene/convert.py uploads them), in place,
    on the current stream after the frames already queued; the rest of
    the arena is not copied. Returns `data`."""
    import torch

    rows = chunk.shape[0]
    if offset < 0 or offset + rows > data.shape[0]:
        raise ValueError(f"chunk rows [{offset}, {offset + rows}) outside "
                         f"the arena's {data.shape[0]}")
    src = torch.from_numpy(np.asarray(chunk).astype(np.int64))
    if data.device.type == "cuda":
        src = src.pin_memory()
    data[offset : offset + rows].copy_(src, non_blocking=True)
    return data
