"""Minimal DDS reader and writer.

Counterpart of prosper_tpu/io/dds.py (numpy only, kept as the port's
own copy), Dds.{hpp,cpp} of the reference. The formats the engine uses:
- R9G9B9E5_SHAREDEXP 3D (the Tony McMapface tone-map LUT,
  res/texture/tony_mc_mapface.dds of the reference checkout)
- R8G8B8A8_UNORM / _SRGB 2D with mips (the texture cache's format)
- R16G16B16A16_FLOAT and R32G32B32A32_FLOAT 2D (HDR dumps)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_DDS_MAGIC = b"DDS "
_DX10 = b"DX10"

# DXGI formats we support
DXGI_R32G32B32A32_FLOAT = 2
DXGI_R16G16B16A16_FLOAT = 10
DXGI_R9G9B9E5 = 67
DXGI_R8G8B8A8_UNORM = 28
DXGI_R8G8B8A8_SRGB = 29
DXGI_BC7_UNORM = 98
DXGI_BC7_SRGB = 99

_HEADER_FLAGS_REQUIRED = 0x1 | 0x2 | 0x4 | 0x1000  # caps|height|width|pixelformat
_RESOURCE_DIM_TEX2D = 3
_RESOURCE_DIM_TEX3D = 4


@dataclass
class DdsImage:
    dxgi_format: int
    width: int
    height: int
    depth: int
    mips: list[np.ndarray]  # each (D?, H, W, C) float32 or (H, W, C) uint8


def _decode_r9g9b9e5(raw: np.ndarray) -> np.ndarray:
    """uint32 array -> (..., 3) float32 shared-exponent decode."""
    r = (raw & 0x1FF).astype(np.float32)
    g = ((raw >> 9) & 0x1FF).astype(np.float32)
    b = ((raw >> 18) & 0x1FF).astype(np.float32)
    e = ((raw >> 27) & 0x1F).astype(np.int32)
    scale = np.exp2(e.astype(np.float32) - 15.0 - 9.0)
    return np.stack([r * scale, g * scale, b * scale], axis=-1)


def read_dds(path: str) -> DdsImage:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _DDS_MAGIC:
        raise ValueError(f"{path}: not a DDS file")
    hdr = struct.unpack("<31I", data[4:128])
    height, width = hdr[2], hdr[3]
    depth = max(hdr[5], 1)
    mip_count = max(hdr[6], 1)
    fourcc = data[84:88]
    off = 128
    if fourcc == _DX10:
        dxgi, dim, _misc, array_size, _misc2 = struct.unpack("<5I", data[128:148])
        off = 148
        if array_size != 1:
            raise NotImplementedError("DDS texture arrays not supported")
    else:
        # Legacy header: only accept an explicit 32-bit RGBA layout with
        # the R8G8B8A8 channel masks; anything else (BC fourCCs, BGRA,
        # 24-bit RGB, luminance) would decode to garbage.
        pf_flags, bit_count, rmask, gmask, bmask, amask = struct.unpack(
            "<I4xIIIII", data[80:108]
        )
        if pf_flags & 0x4:  # DDPF_FOURCC (non-DX10)
            raise NotImplementedError(
                f"legacy DDS fourCC {fourcc!r} not supported"
            )
        if not (
            pf_flags & 0x40  # DDPF_RGB
            and bit_count == 32
            and rmask == 0x000000FF
            and gmask == 0x0000FF00
            and bmask == 0x00FF0000
            and amask in (0xFF000000, 0)
        ):
            raise NotImplementedError(
                "legacy DDS pixel format not R8G8B8A8 "
                f"(flags=0x{pf_flags:x} bits={bit_count} masks="
                f"{rmask:#x}/{gmask:#x}/{bmask:#x}/{amask:#x})"
            )
        dxgi = DXGI_R8G8B8A8_UNORM
        dim = _RESOURCE_DIM_TEX3D if depth > 1 else _RESOURCE_DIM_TEX2D

    mips: list[np.ndarray] = []
    w, h, d = width, height, depth
    for _ in range(mip_count):
        if dxgi == DXGI_R9G9B9E5:
            n = w * h * d
            raw = np.frombuffer(data, dtype="<u4", count=n, offset=off)
            off += n * 4
            img = _decode_r9g9b9e5(raw)
            img = img.reshape((d, h, w, 3)) if dim == _RESOURCE_DIM_TEX3D else img.reshape((h, w, 3))
        elif dxgi in (DXGI_R8G8B8A8_UNORM, DXGI_R8G8B8A8_SRGB):
            n = w * h * d * 4
            raw = np.frombuffer(data, dtype=np.uint8, count=n, offset=off)
            off += n
            img = raw.reshape((d, h, w, 4)) if dim == _RESOURCE_DIM_TEX3D else raw.reshape((h, w, 4))
        elif dxgi == DXGI_R16G16B16A16_FLOAT:
            n = w * h * d * 4
            raw = np.frombuffer(data, dtype="<f2", count=n, offset=off)
            off += n * 2
            img = raw.astype(np.float32)
            img = img.reshape((d, h, w, 4)) if dim == _RESOURCE_DIM_TEX3D else img.reshape((h, w, 4))
        elif dxgi == DXGI_R32G32B32A32_FLOAT:
            n = w * h * d * 4
            raw = np.frombuffer(data, dtype="<f4", count=n, offset=off)
            off += n * 4
            img = raw.reshape((d, h, w, 4)) if dim == _RESOURCE_DIM_TEX3D else raw.reshape((h, w, 4))
        else:
            raise NotImplementedError(f"DXGI format {dxgi} not supported")
        mips.append(img)
        w, h, d = max(w // 2, 1), max(h // 2, 1), max(d // 2, 1)

    return DdsImage(dxgi_format=dxgi, width=width, height=height, depth=depth, mips=mips)


def write_dds_rgba8(path: str, mips: list[np.ndarray], srgb: bool = False) -> None:
    """Write a 2D RGBA8 DDS with a mip chain (our texture-cache format)."""
    h, w = mips[0].shape[:2]
    flags = _HEADER_FLAGS_REQUIRED | 0x20000  # mipmapcount
    hdr = [124, flags, h, w, w * 4, 0, len(mips)] + [0] * 11
    # pixel format: fourCC DX10
    pf = [32, 0x4, int.from_bytes(_DX10, "little"), 0, 0, 0, 0, 0]
    caps = [0x1000 | (0x400008 if len(mips) > 1 else 0), 0, 0, 0, 0]
    dxgi = DXGI_R8G8B8A8_SRGB if srgb else DXGI_R8G8B8A8_UNORM
    with open(path, "wb") as f:
        f.write(_DDS_MAGIC)
        f.write(struct.pack("<31I", *(hdr + pf + caps)))
        f.write(struct.pack("<5I", dxgi, _RESOURCE_DIM_TEX2D, 0, 1, 0))
        for m in mips:
            assert m.dtype == np.uint8 and m.shape[-1] == 4
            f.write(m.tobytes())
