"""The port's DDS and KTX readers and its Tony McMapface loader against
prosper_tpu's, on files the tests write: the decoded arrays are equal
(exact), and a KTX cubemap serves as the path tracer's environment."""

import struct

import numpy as np
import pytest
import torch

from prosper_tpu.io import dds as jdds
from prosper_tpu.io import ktx as jktx
from prosper_tpu.ops import tonemap as jtonemap
from prosper_tpu_torch.io import dds as tdds
from prosper_tpu_torch.io import ktx as tktx
from prosper_tpu_torch.ops import ibl as tibl
from prosper_tpu_torch.ops import tonemap as ttonemap


def _write_r9g9b9e5(path, words: np.ndarray) -> None:
    """A DX10 DDS of R9G9B9E5 words, (D, H, W) -> a 3D texture, (H, W) ->
    2D (the layout of the reference's tony_mc_mapface.dds)."""
    if words.ndim == 3:
        d, h, w = words.shape
        dim = 4
    else:
        (h, w), d, dim = words.shape, 1, 3
    hdr = [124, 0x1 | 0x2 | 0x4 | 0x1000 | 0x800000, h, w, w * 4, d, 1]
    hdr += [0] * 11
    pf = [32, 0x4, int.from_bytes(b"DX10", "little"), 0, 0, 0, 0, 0]
    caps = [0x1000, 0x200000 if d > 1 else 0, 0, 0, 0]
    with open(path, "wb") as f:
        f.write(b"DDS ")
        f.write(struct.pack("<31I", *(hdr + pf + caps)))
        f.write(struct.pack("<5I", 67, dim, 0, 1, 0))
        f.write(words.astype("<u4").tobytes())


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    mant = rng.integers(0, 512, shape + (3,), dtype=np.uint32)
    exp = rng.integers(10, 20, shape, dtype=np.uint32)
    return (mant[..., 0] | (mant[..., 1] << 9) | (mant[..., 2] << 18)
            | (exp << 27)).astype(np.uint32)


def _same_dds(a, b):
    assert (a.dxgi_format, a.width, a.height, a.depth) == (
        b.dxgi_format, b.width, b.height, b.depth)
    assert len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(4, 6, 5), (7, 9)])
def test_dds_r9g9b9e5_equals_jax(tmp_path, shape):
    path = str(tmp_path / "shared_exp.dds")
    _write_r9g9b9e5(path, _words(shape, 0))
    got, want = tdds.read_dds(path), jdds.read_dds(path)
    _same_dds(got, want)
    assert got.dxgi_format == tdds.DXGI_R9G9B9E5
    assert got.mips[0].shape == shape + (3,)


@pytest.mark.parametrize("srgb", [False, True])
def test_dds_rgba8_equals_jax(tmp_path, srgb):
    rng = np.random.default_rng(1)
    mips = [rng.integers(0, 256, (s, s * 3 // 2, 4), dtype=np.uint8)
            for s in (8, 4, 2)]
    path = str(tmp_path / "rgba8.dds")
    tdds.write_dds_rgba8(path, mips, srgb=srgb)
    got, want = tdds.read_dds(path), jdds.read_dds(path)
    _same_dds(got, want)
    for m, g in zip(mips, got.mips):
        np.testing.assert_array_equal(g, m)
    other = str(tmp_path / "jax_written.dds")
    jdds.write_dds_rgba8(other, mips, srgb=srgb)
    assert open(other, "rb").read() == open(path, "rb").read()
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="not a DDS"):
        tdds.read_dds(path)


@pytest.mark.parametrize("fmt", ["RGBA8", "RGB8", "RGBA16F", "RGBA32F"])
def test_ktx_equals_jax_and_serves_as_env(tmp_path, fmt):
    gl = getattr(tktx, f"GL_{fmt}")
    dtype, comps = tktx._FORMATS[gl]
    rng = np.random.default_rng(2)
    mips = []
    for s in (8, 4):  # RGB8 rows of 24 and 12 bytes: no row padding
        m = rng.uniform(0, 255 if dtype == np.uint8 else 4.0,
                        (6, s, s, comps))
        mips.append(m.astype(dtype))
    path = str(tmp_path / f"env_{fmt}.ktx")
    tktx.write_ktx(path, mips, gl)
    got, want = tktx.read_ktx(path), jktx.read_ktx(path)
    assert (got.gl_internal_format, got.width, got.height, got.faces) == (
        want.gl_internal_format, want.width, want.height, want.faces)
    for x, y in zip(got.mips, want.mips):
        np.testing.assert_array_equal(x, y)
    cube = tktx.ktx_to_cubemap(got)
    np.testing.assert_array_equal(cube, jktx.ktx_to_cubemap(want))
    assert cube.shape == (6, 8, 8, 3) and cube.dtype == np.float32
    # the cubemap as an environment: the face centers read their texels
    env = torch.as_tensor(cube)
    d = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0],
                      [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]])
    taps = tibl.sample_cubemap(env, d)
    centers = env[:, 3:5, 3:5].mean(dim=(1, 2))
    torch.testing.assert_close(taps, centers, rtol=1e-5, atol=1e-6)


def test_ktx_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "flat.ktx")
    tktx.write_ktx(path, [np.zeros((1, 4, 4, 4), np.uint8)])
    with pytest.raises(ValueError, match="cubemap"):
        tktx.ktx_to_cubemap(tktx.read_ktx(path))
    bad = str(tmp_path / "bad.ktx")
    with open(bad, "wb") as f:
        f.write(b"not a ktx file at all")
    with pytest.raises(ValueError, match="KTX1"):
        tktx.read_ktx(bad)


def test_load_tony_mc_mapface_equals_jax(tmp_path):
    path = str(tmp_path / "tony_mc_mapface.dds")
    _write_r9g9b9e5(path, _words((48, 48, 48), 3))
    got = ttonemap.load_tony_mc_mapface(path)
    want = jtonemap.load_tony_mc_mapface(path)
    assert got.shape == (48 ** 3, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    small = str(tmp_path / "small.dds")
    _write_r9g9b9e5(small, _words((8, 8, 8), 4))
    with pytest.raises(ValueError, match="48"):
        ttonemap.load_tony_mc_mapface(small)


def test_entry_takes_a_lut_path(tmp_path):
    """entry(lut_path=...) tone maps through the file's LUT: another
    image than the synthetic LUT's, the same as tone_map with it."""
    from prosper_tpu_torch.entry import entry
    from prosper_tpu_torch.ops.tonemap import tone_map

    path = str(tmp_path / "tony_mc_mapface.dds")
    _write_r9g9b9e5(path, _words((48, 48, 48), 5))
    fn, (scene, cam, _) = entry("cpu", width=16, height=16, max_bounces=1,
                                lut_path=path)
    img, state, _ = fn(scene, cam, 0)
    lut = torch.as_tensor(ttonemap.load_tony_mc_mapface(path))
    torch.testing.assert_close(img, tone_map(state[0], lut), rtol=0, atol=0)
    fn0, _ = entry("cpu", width=16, height=16, max_bounces=1)
    assert not torch.equal(fn0(scene, cam, 0)[0], img)
