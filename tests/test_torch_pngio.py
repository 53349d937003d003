"""The port's PNG codec (``ccrs_tpu_torch.pngio``) against imageio/PIL.

- It reads what imageio/PIL write, 8- and 16-bit, gray, gray+alpha, RGB
  and RGBA, and files whose rows use each of the five filter types (made
  by a small encoder in this file), pixel for pixel.
- imageio reads what it writes, pixel for pixel.
- Adam7-interlaced, palette and sub-byte files raise.
"""

import struct
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from ccrs_tpu_torch.pngio import read_png, write_png

COLOR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    # a smooth ramp plus noise: the filters have something to predict
    h, w = shape[:2]
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * (hi // (h + w))).astype(np.int64)
    if len(shape) == 3:
        ramp = ramp[..., None] + np.arange(shape[2]) * 7
    img = (ramp + rng.integers(0, hi // 16, shape)) % hi
    return img.astype(dtype)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(path, img, filters, interlace=0):
    """Test-side PNG encoder: row y uses filter ``filters[y % len]``."""
    img = np.asarray(img)
    chans = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 if img.dtype == np.uint8 else 16
    color_type = COLOR_TYPE[chans]
    h, w = img.shape[:2]
    data = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8)
    bpp = chans * depth // 8
    out = bytearray()
    prev = np.zeros(data.shape[1], np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        row = data[y].astype(np.int64)
        enc = np.zeros_like(row)
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            enc[i] = (row[i] - pred) % 256
        out.append(f)
        out += bytes(enc.astype(np.uint8))
        prev = row

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)))
        fh.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        fh.write(chunk(b"IEND", b""))


SHAPES = {"gray": (23, 17), "gray_alpha": (23, 17, 2), "rgb": (23, 17, 3), "rgba": (23, 17, 4)}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["gray", "rgb"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_reads_each_filter_type(tmp_path, filt, layout, dtype):
    img = _image(SHAPES[layout], dtype, seed=filt)
    p = tmp_path / "f.png"
    _encode(p, img, [filt])
    got = read_png(str(p))
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("layout", list(SHAPES))
def test_reads_mixed_filters(tmp_path, layout):
    img = _image(SHAPES[layout], np.uint8, seed=9)
    p = tmp_path / "m.png"
    _encode(p, img, [4, 0, 3, 1, 2, 4, 4, 3])
    np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize("layout", list(SHAPES))
def test_reads_what_imageio_writes(tmp_path, layout):
    img = _image((120, 96) + SHAPES[layout][2:], np.uint8, seed=3)
    p = tmp_path / "i.png"
    iio.imwrite(str(p), img)  # PIL picks the filters (adaptive)
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_reads_16bit_gray_from_pil(tmp_path):
    img = _image((64, 80), np.uint16, seed=4)
    p = tmp_path / "g16.png"
    Image.fromarray(img).save(str(p))
    got = read_png(str(p))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize(
    "layout,dtype",
    [(layout, np.uint8) for layout in SHAPES] + [("gray", np.uint16)],
)
def test_imageio_reads_what_the_port_writes(tmp_path, layout, dtype):
    img = _image((40, 33) + SHAPES[layout][2:], dtype, seed=5)
    p = tmp_path / "w.png"
    write_png(str(p), img)
    back = iio.imread(str(p))
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize("layout", ["gray_alpha", "rgb", "rgba"])
def test_port_writes_16bit_color(tmp_path, layout):
    """PIL folds 16-bit color to 8 bits, so the samples are read back raw:
    big-endian, after the filter byte of each row."""
    img = _image((12, 9) + SHAPES[layout][2:], np.uint16, seed=6)
    p = tmp_path / "c16.png"
    write_png(str(p), img)
    data = p.read_bytes()
    start = data.index(b"IDAT") + 4
    (length,) = struct.unpack(">I", data[start - 8 : start - 4])
    raw = np.frombuffer(zlib.decompress(data[start : start + length]), np.uint8)
    rows = raw.reshape(12, -1)[:, 1:]
    np.testing.assert_array_equal(rows.copy().view(">u2").reshape(img.shape), img)
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_port_writes_filter_zero(tmp_path):
    p = tmp_path / "z.png"
    write_png(str(p), _image((10, 12), np.uint8))
    data = p.read_bytes()
    start = data.index(b"IDAT") + 4
    (length,) = struct.unpack(">I", data[start - 8 : start - 4])
    raw = zlib.decompress(data[start : start + length])
    assert all(raw[y * 13] == 0 for y in range(10))


def test_adam7_raises(tmp_path):
    p = tmp_path / "a.png"
    _encode(p, _image((8, 8), np.uint8), [0], interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        read_png(str(p))


def test_palette_and_subbyte_raise(tmp_path):
    p = tmp_path / "p.png"
    Image.fromarray(_image((8, 8), np.uint8)).convert("P").save(str(p))
    with pytest.raises(ValueError, match="palette"):
        read_png(str(p))
    q = tmp_path / "b.png"
    Image.fromarray(_image((8, 8), np.uint8) > 128).save(str(q))
    with pytest.raises(ValueError, match="bit depth"):
        read_png(str(q))
