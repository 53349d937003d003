"""The port's PNG codec (``ccrs_tpu_torch.pngio``) against imageio/PIL.

- It reads what imageio/PIL write, 8- and 16-bit, gray, gray+alpha, RGB
  and RGBA, and files whose rows use each of the five filter types (made
  by a small encoder in this file), pixel for pixel.
- imageio reads what it writes, pixel for pixel.
- Palette files (1/2/4/8 bits, with and without ``tRNS``), 1/2/4-bit gray
  and Adam7-interlaced files, built here from bytes with ``zlib`` and
  ``struct``, decode to the arrays they were made from, to what PIL reads
  and, where cv2 imports, to what ``cv2.imread(IMREAD_UNCHANGED)`` returns
  (channel count included); files PIL wrote (mode "P", mode "1") too.
- An unknown critical chunk, a bad compression method, a bad bit depth
  and a palette file without ``PLTE`` raise.
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


def _filter_rows(data, bpp, filters):
    """(h, n) bytes -> filtered scanlines; row y uses ``filters[y % len]``."""
    out = bytearray()
    prev = np.zeros(data.shape[1], np.int64)
    for y in range(data.shape[0]):
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
    return bytes(out)


def _chunk(t, p):
    return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _encode(path, img, filters, interlace=0, depth=None, palette=None, extra=b"",
            comp=0):
    """Test-side PNG encoder: row y uses filter ``filters[y % len]``.

    ``img`` holds samples, (h, w) or (h, w, C); ``depth`` below 8 packs a
    (h, w) array of values below ``2**depth``, most significant bit first;
    ``palette`` (n, 3) makes the file a palette file of those indices;
    ``interlace=1`` writes the seven Adam7 passes."""
    img = np.asarray(img)
    chans = 1 if img.ndim == 2 else img.shape[2]
    if depth is None:
        depth = 8 if img.dtype == np.uint8 else 16
    color_type = 3 if palette is not None else COLOR_TYPE[chans]
    h, w = img.shape[:2]
    bpp = max(1, chans * depth // 8)

    def rows(part):
        ph = part.shape[0]
        if depth == 16:
            return part.astype(">u2").reshape(ph, -1).view(np.uint8)
        if depth == 8:
            return part.astype(np.uint8).reshape(ph, -1)
        bits = np.unpackbits(part.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
        return np.packbits(bits.reshape(ph, -1), axis=1)

    if interlace:
        parts = [img[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    else:
        parts = [img]
    out = b"".join(_filter_rows(rows(q), bpp, filters) for q in parts if q.size)
    if palette is not None:
        extra = _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) + extra
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, comp, 0, interlace)))
        fh.write(extra)
        fh.write(_chunk(b"IDAT", zlib.compress(out)))
        fh.write(_chunk(b"IEND", b""))


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


def _cv2_reads(path):
    """What ``cv2.imread(IMREAD_UNCHANGED)`` returns, channels in RGB(A)
    order; None where cv2 does not import."""
    try:
        import cv2
    except ImportError:
        return None
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0] + ([3] if img.shape[2] == 4 else [])]
    return img


def _check_against_readers(path, got, pil_mode):
    """``got`` equals what PIL reads (converted to ``pil_mode``) and, where
    cv2 imports, what cv2 returns, shape and dtype included."""
    with Image.open(str(path)) as im:
        ref = np.asarray(im.convert(pil_mode)) if pil_mode else np.asarray(im)
    np.testing.assert_array_equal(got, ref)
    cv = _cv2_reads(path)
    if cv is not None:
        assert got.shape == cv.shape and got.dtype == cv.dtype
        np.testing.assert_array_equal(got, cv)


@pytest.mark.parametrize("trns", [False, True], ids=["plain", "trns"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_reads_palette(tmp_path, depth, trns):
    """Palette files expand through PLTE to RGB; with a tRNS chunk to RGBA,
    as cv2's IMREAD_UNCHANGED does (entries beyond tRNS are opaque)."""
    rng = np.random.default_rng(depth)
    n = 1 << depth
    pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    idx = rng.integers(0, n, (13, 11))
    extra = b""
    want = pal[idx]
    if trns:
        alpha = rng.integers(0, 255, n // 2 + 1, dtype=np.uint8)
        extra = _chunk(b"tRNS", alpha.tobytes())
        full = np.full(n, 255, np.uint8)
        full[: len(alpha)] = alpha
        want = np.concatenate([want, full[idx][..., None]], axis=-1)
    p = tmp_path / "p.png"
    _encode(p, idx, [0, 1, 2, 3, 4], depth=depth, palette=pal, extra=extra)
    got = read_png(str(p))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    _check_against_readers(p, got, "RGBA" if trns else "RGB")


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_reads_subbyte_gray(tmp_path, depth):
    """1/2/4-bit gray scales to 0..255 by 255 // (2**depth - 1), as cv2
    and PIL scale it; the width is no multiple of the samples per byte."""
    rng = np.random.default_rng(10 + depth)
    v = rng.integers(0, 1 << depth, (9, 13))
    p = tmp_path / "g.png"
    _encode(p, v, [0, 2, 1, 4, 3], depth=depth)
    got = read_png(str(p))
    assert got.dtype == np.uint8 and got.shape == v.shape
    np.testing.assert_array_equal(got, v * (255 // ((1 << depth) - 1)))
    _check_against_readers(p, got, "L")


ADAM7_CASES = {
    "gray8": ((23, 17), np.uint8, None),
    "rgb8": ((23, 17, 3), np.uint8, None),
    "gray16": ((23, 17), np.uint16, None),
    "rgba8": ((9, 10, 4), np.uint8, None),
    "gray8_narrow": ((11, 5), np.uint8, None),  # passes 2 and 4 are empty at width 1..4
    "gray8_3x2": ((2, 3), np.uint8, None),
    "gray8_1x1": ((1, 1), np.uint8, None),
    "gray1_narrow": ((7, 6), None, 1),
    "gray4": ((12, 19), None, 4),
}


@pytest.mark.parametrize("case", list(ADAM7_CASES))
def test_reads_adam7(tmp_path, case):
    """Seven passes, each unfiltered at its own row width, scattered back."""
    shape, dtype, depth = ADAM7_CASES[case]
    if depth is None:
        img = _image(shape, dtype, seed=len(case))
        want = img
    else:
        img = np.random.default_rng(3).integers(0, 1 << depth, shape)
        want = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    p = tmp_path / "a.png"
    _encode(p, img, [4, 1, 0, 3, 2], interlace=1, depth=depth)
    got = read_png(str(p))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    cv = _cv2_reads(p)
    if cv is not None:
        np.testing.assert_array_equal(got, cv)
    if dtype != np.uint16:  # PIL folds some 16-bit layouts
        _check_against_readers(p, got, "L" if depth else None)


def test_reads_adam7_palette(tmp_path):
    rng = np.random.default_rng(8)
    pal = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    idx = rng.integers(0, 4, (10, 9))
    p = tmp_path / "ap.png"
    _encode(p, idx, [0, 4], interlace=1, depth=2, palette=pal)
    got = read_png(str(p))
    np.testing.assert_array_equal(got, pal[idx])
    _check_against_readers(p, got, "RGB")


def test_reads_palette_and_bilevel_from_pil(tmp_path):
    """Files PIL writes: an adaptive-palette mode "P" file and a mode "1"
    (1-bit gray) file."""
    rgb = _image((40, 33, 3), np.uint8, seed=2)
    p = tmp_path / "p.png"
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16).save(str(p))
    _check_against_readers(p, read_png(str(p)), "RGB")
    q = tmp_path / "b.png"
    bits = _image((8, 13), np.uint8) > 128
    Image.fromarray(bits).save(str(q))
    got = read_png(str(q))
    np.testing.assert_array_equal(got, bits * np.uint8(255))
    _check_against_readers(q, got, "L")


def test_refuses_what_it_cannot_decode(tmp_path):
    img = _image((8, 8), np.uint8)
    p = tmp_path / "c.png"
    _encode(p, img, [0], extra=_chunk(b"ABCD", b"xyz"))
    with pytest.raises(ValueError, match="unknown critical chunk"):
        read_png(str(p))
    _encode(p, img, [0], extra=_chunk(b"abCd", b"xyz"))  # ancillary: skipped
    np.testing.assert_array_equal(read_png(str(p)), img)
    _encode(p, img, [0], comp=1)
    with pytest.raises(ValueError, match="compression"):
        read_png(str(p))
    _encode(p, img, [0], depth=3)
    with pytest.raises(ValueError, match="bit depth 3"):
        read_png(str(p))
    _encode(p, img % 4, [0], depth=2, palette=np.zeros((4, 3), np.uint8))
    data = p.read_bytes()
    start = data.index(b"PLTE") - 4
    p.write_bytes(data[:start] + data[start + 12 + 12 :])  # drop the PLTE chunk
    with pytest.raises(ValueError, match="PLTE"):
        read_png(str(p))
    _encode(p, np.full((4, 4), 3), [0], depth=2, palette=np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match="outside PLTE"):
        read_png(str(p))
