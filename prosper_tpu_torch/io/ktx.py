"""KTX (v1) reader and writer for environment cubemaps.

Counterpart of prosper_tpu/io/ktx.py (numpy only, kept as the port's own
copy), Ktx.* and TextureCubemap of the reference, which load the skybox
and IBL sources from KTX cubemaps. `ktx_to_cubemap` turns a cubemap file
into the (6, S, S, 3) array that ops/ibl.py and the path tracer's `env`
take.

Supports uncompressed GL_RGBA8 / GL_RGB8 / GL_RGBA16F / GL_RGBA32F 2D
and cubemap textures with mips.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_KTX1_MAGIC = b"\xabKTX 11\xbb\r\n\x1a\n"

GL_RGBA8 = 0x8058
GL_RGB8 = 0x8051
GL_RGBA16F = 0x881A
GL_RGBA32F = 0x8814

_FORMATS = {
    GL_RGBA8: (np.uint8, 4),
    GL_RGB8: (np.uint8, 3),
    GL_RGBA16F: (np.float16, 4),
    GL_RGBA32F: (np.float32, 4),
}


@dataclass
class KtxImage:
    gl_internal_format: int
    width: int
    height: int
    faces: int  # 1 or 6
    mips: list[np.ndarray]  # each (faces, H, W, C)


def read_ktx(path: str) -> KtxImage:
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:12] != _KTX1_MAGIC:
        raise ValueError(f"{path}: not a KTX1 file")
    (
        endianness,
        gl_type,
        gl_type_size,
        gl_format,
        gl_internal,
        gl_base_internal,
        w,
        h,
        depth,
        n_array,
        n_faces,
        n_mips,
        kv_bytes,
    ) = struct.unpack("<13I", data[12:64])
    if endianness != 0x04030201:
        raise NotImplementedError("big-endian KTX")
    if n_array > 1 or depth > 1:
        raise NotImplementedError("KTX array/3D textures")
    if gl_internal not in _FORMATS:
        raise NotImplementedError(f"KTX internal format 0x{gl_internal:x}")
    dtype, comps = _FORMATS[gl_internal]
    n_mips = max(n_mips, 1)
    n_faces = max(n_faces, 1)

    off = 64 + kv_bytes
    mips = []
    mw, mh = w, max(h, 1)
    for _m in range(n_mips):
        (image_size,) = struct.unpack("<I", data[off : off + 4])
        off += 4
        face_arrays = []
        itemsize = np.dtype(dtype).itemsize
        row_bytes = mw * comps * itemsize
        # GL UNPACK_ALIGNMENT=4: each row is padded to a 4-byte multiple
        # (matters for RGB8 with width not divisible by 4)
        padded_row = (row_bytes + 3) & ~3
        for _f in range(n_faces):
            if padded_row == row_bytes:
                n = mw * mh * comps
                arr = np.frombuffer(
                    data, dtype=dtype, count=n, offset=off
                ).reshape(mh, mw, comps)
            else:
                raw = np.frombuffer(
                    data, dtype=np.uint8, count=mh * padded_row, offset=off
                ).reshape(mh, padded_row)
                arr = (
                    raw[:, :row_bytes]
                    .copy()
                    .view(dtype)
                    .reshape(mh, mw, comps)
                )
            face_arrays.append(arr)
            off += (mh * padded_row + 3) & ~3  # cube padding to 4 bytes
        del image_size
        mips.append(np.stack(face_arrays))
        mw, mh = max(mw // 2, 1), max(mh // 2, 1)
    return KtxImage(
        gl_internal_format=gl_internal, width=w, height=max(h, 1),
        faces=n_faces, mips=mips,
    )


def write_ktx(
    path: str, mips: list[np.ndarray], gl_internal: int = GL_RGBA8
) -> None:
    """Write faces-major mips [(F, H, W, C), ...] (test fixture writer)."""
    dtype, comps = _FORMATS[gl_internal]
    f, h, w = mips[0].shape[:3]
    gl_type = 0x1401 if dtype == np.uint8 else (0x140B if dtype == np.float16 else 0x1406)
    gl_format = 0x1908 if comps == 4 else 0x1907
    with open(path, "wb") as fp:
        fp.write(_KTX1_MAGIC)
        fp.write(
            struct.pack(
                "<13I",
                0x04030201,
                gl_type,
                np.dtype(dtype).itemsize,
                gl_format,
                gl_internal,
                gl_format,
                w,
                h,
                0,
                0,
                f,
                len(mips),
                0,
            )
        )
        for m in mips:
            face_bytes = m[0].astype(dtype).tobytes()
            fp.write(struct.pack("<I", len(face_bytes)))
            for face in m:
                b = face.astype(dtype).tobytes()
                fp.write(b)
                fp.write(b"\0" * ((-len(b)) % 4))


def ktx_to_cubemap(img: KtxImage) -> np.ndarray:
    """(6, S, S, 3) float32 linear cubemap for ops/ibl.py."""
    if img.faces != 6:
        raise ValueError("not a cubemap")
    m0 = img.mips[0].astype(np.float32)
    if img.gl_internal_format in (GL_RGBA8, GL_RGB8):
        m0 = m0 / 255.0
    return np.ascontiguousarray(m0[..., :3])
