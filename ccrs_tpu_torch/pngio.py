"""PNG codec on the standard library's ``zlib`` and ``struct`` plus numpy.

The port reads and writes its datasets through this module on every
machine, so the loader has one code path wherever it runs and needs no
image package.  The reader takes every layout of the PNG specification:

- 8- and 16-bit grayscale, gray+alpha, RGB and RGBA;
- 1-, 2- and 4-bit grayscale, scaled to 0..255 (sample * 255 // max);
- palette files at 1, 2, 4 and 8 bits, expanded through ``PLTE`` to RGB,
  or to RGBA when the file carries a ``tRNS`` chunk;
- Adam7-interlaced files of any of these.

The writer emits non-interlaced 8- and 16-bit gray, gray+alpha, RGB and
RGBA only.

The reader undoes all five scanline filters.  None and Up are vectorised
over the row, Sub is a cumulative sum mod 256 over each byte lane, and
Average and Paeth, which are sequential within a row, run in a small host
C++ routine (``csrc/png_unfilter.cpp``) built by g++ at first use into
``ccrs_tpu_torch/_build/`` and called through ctypes.  A file whose rows
all use filter None (what ``write_png`` emits) skips the row loop.

The writer emits filter type 0 on every row.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from .native_build import BUILD_DIR, ensure_built

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: color type -> samples per pixel (0 gray, 2 RGB, 3 palette index,
#: 4 gray+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: color type -> bit depths the specification allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_COLOR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "png_unfilter.cpp")
_SO = os.path.join(BUILD_DIR, "libpngunfilter.so")
_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the unfilter routine if needed; returns its path."""
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO]
    return ensure_built(_SO, [_SRC], cmd)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ccrs_png_unfilter_row.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.ccrs_png_unfilter_row.restype = ctypes.c_int
            _lib = lib
        return _lib


def _chunks(data: bytes, path: str):
    """Yield (type, payload) of every chunk, checking lengths and CRCs."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated {ctype!r} chunk")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + n) filtered scanlines -> (H, n) reconstructed bytes."""
    ftypes = raw[:, 0]
    rows = raw[:, 1:]
    if not ftypes.any():
        return rows
    if int(ftypes.max()) > 4:
        raise ValueError(f"invalid PNG filter type {int(ftypes.max())}")
    H, n = rows.shape
    out = np.empty((H, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    lib = _load() if (ftypes >= 3).any() else None
    for y in range(H):
        f = int(ftypes[y])
        cur = out[y]
        if f == 0:  # None
            cur[:] = rows[y]
        elif f == 1:  # Sub: running sum mod 256 over each byte lane
            lanes = rows[y].reshape(-1, bpp)
            cur[:] = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            np.add(rows[y], prev, out=cur)
        else:  # Average / Paeth: sequential within the row
            cur[:] = rows[y]
            rc = lib.ccrs_png_unfilter_row(
                cur.ctypes.data, prev.ctypes.data, f, n, bpp
            )
            if rc != 0:
                raise ValueError(f"PNG filter type {f} not reconstructed")
        prev = cur
    return out


def _samples(raw: np.ndarray, pos: int, width: int, height: int,
             channels: int, depth: int):
    """Unfilter one image (or one Adam7 pass) of ``height`` scanlines that
    starts at byte ``pos`` of the inflated stream; returns its samples as
    (height, width, channels), uint8 or uint16, and the byte after it."""
    n = (width * channels * depth + 7) // 8
    end = pos + height * (n + 1)
    if end > raw.size:
        raise ValueError(f"image data ends at byte {raw.size}, expected {end}")
    rows = _unfilter(raw[pos:end].reshape(height, n + 1), max(1, channels * depth // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        img = rows
    else:  # 1, 2 or 4 bits, most significant first; rows pad to a byte
        bits = np.unpackbits(np.ascontiguousarray(rows), axis=1)
        bits = bits.reshape(height, n * 8 // depth, depth)[:, :width]
        img = bits @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return img.reshape(height, width, channels), end


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file.

    Returns (H, W) for grayscale or (H, W, C) with C = 2 (gray+alpha),
    3 (RGB, also a palette file) or 4 (RGBA, also a palette file with a
    ``tRNS`` chunk).  dtype is uint16 for 16-bit files and uint8 for all
    others: 1-, 2- and 4-bit gray is scaled to 0..255, palette indices are
    expanded to their 8-bit colours.  Adam7-interlaced files are
    de-interlaced.  ``tRNS`` is ignored except in palette files.  Raises
    ValueError for a damaged file, an unknown critical chunk or an unknown
    compression, filter or interlace method.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = plte = trns = None
    idat = []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif ctype[0:1].isupper() and ctype != b"IEND":
            raise ValueError(f"{path}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG color type {color}")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"{path}: PNG bit depth {depth} is not valid for color type {color}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"{path}: unknown PNG compression/filter/interlace method")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        if interlace == 0:
            img, end = _samples(raw, 0, width, height, channels, depth)
        else:
            img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
            end = 0
            for x0, y0, dx, dy in _ADAM7:
                pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
                if pw <= 0 or ph <= 0:  # an empty pass has no bytes at all
                    continue
                img[y0::dy, x0::dx], end = _samples(raw, end, pw, ph, channels, depth)
        if end != raw.size:
            raise ValueError(f"image data size {raw.size} != {end}")
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if color == 3:
        table = plte
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[: len(trns)] = trns[: len(plte)]
            table = np.concatenate([plte, alpha[:, None]], axis=1)
        if int(img.max(initial=0)) >= len(table):
            raise ValueError(f"{path}: palette index {int(img.max())} outside PLTE")
        return table[img[..., 0]]
    if depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    return img[..., 0] if channels == 1 else img


def write_png(path: str, img) -> None:
    """Encode a (H, W) or (H, W, C) uint8/uint16 array, C in 1..4, as a
    non-interlaced PNG with filter type 0 on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: dtype {img.dtype} (expected uint8 or uint16)")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png: shape {img.shape} (expected (H, W[, 1..4]))")
    height, width, channels = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.reshape(height, -1).view(np.uint8)
    raw = np.zeros((height, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
