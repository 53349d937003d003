"""ctypes bridge to the native quad extractor.

The irregular stage of the detector (connected components, contours, quad
fit) stays host C++: ``csrc/quadproc.cpp``, the port's copy of the JAX
package's source (equal byte for byte; a test holds them equal), and
``csrc/quadstage.cpp``, which includes it and adds the detector's whole
quad stage of a chunk as one call (``extract_quad_stage``: both erosion
levels of the packed bitmaps, the level-2 rule, scale compensation and the
merge of the levels, OpenMP over frames, with per-thread scratch kept
across calls).  The stage labels dark components from runs of the packed
words and hands each to quadproc.cpp's own trace and checks, so its quads
are ``quadproc_extract``'s.  One library holds both, compiled with the JAX
package's g++ flags into ``ccrs_tpu_torch/_build/`` at first use and
rebuilt when either source changes.  ``extract_quads_batch`` runs
``quadproc_extract`` on unpacked bitmaps, one level.  The
library's two host corner refinements (``refine_corners_native``,
``refine_corners_patches_native``) are bound too; the detector refines on
the device and does not call them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..native_build import BUILD_DIR, ensure_built

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "quadproc.cpp")
_STAGE_SRC = os.path.join(_CSRC, "quadstage.cpp")  # includes _SRC
_SO = os.path.join(BUILD_DIR, "libquadproc.so")

_lock = threading.Lock()
_lib = None

MAX_QUADS = 160
MIN_AREA = 25
MIN_FILL = 0.6


def build() -> str:
    """Compile the quad extractor if needed; returns its path."""
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
        _STAGE_SRC, "-o", _SO,
    ]
    return ensure_built(_SO, [_SRC, _STAGE_SRC], cmd)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.quadproc_extract_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # bins
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W
            ctypes.POINTER(ctypes.c_float),  # quads
            ctypes.POINTER(ctypes.c_int),  # counts
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.quadproc_extract_batch.restype = None
        lib.quadstage_extract_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # packed bitmaps
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # C Hp row_bytes
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H W scale n_tags
            ctypes.POINTER(ctypes.c_float),  # quads
            ctypes.POINTER(ctypes.c_int32),  # counts
            ctypes.c_int, ctypes.c_int,  # max_quads min_area
        ]
        lib.quadstage_extract_batch.restype = ctypes.c_int
        lib.refine_corners_native.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # imgs
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W
            ctypes.POINTER(ctypes.c_float),  # corners (n, 2) in/out
            ctypes.POINTER(ctypes.c_int32),  # img_idx (n,)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, win, iters
        ]
        lib.refine_corners_native.restype = None
        lib.refine_corners_patches.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # patches (n, P, P)
            ctypes.c_int, ctypes.c_int,  # n, P
            ctypes.POINTER(ctypes.c_float),  # corners_local (n, 2) in/out
            ctypes.c_int, ctypes.c_int,  # win, iters
        ]
        lib.refine_corners_patches.restype = None
        _lib = lib
        return lib


def extract_quads_batch(
    binary: np.ndarray,
    max_quads: int = MAX_QUADS,
    min_area: int = MIN_AREA,
    min_fill: float = MIN_FILL,
):
    """Extract candidate dark quads from a batch of binary images.

    Args:
      binary: (B, H, W) uint8 host array, 1 = white, 0 = black.

    Returns:
      quads: (B, max_quads, 4, 2) float32 corner coords (x, y), clockwise
        in image coordinates; rows past counts[b] are undefined.
      counts: (B,) int32 number of quads per image.
    """
    lib = _load()
    binary = np.ascontiguousarray(binary, dtype=np.uint8)
    B, H, W = binary.shape
    quads = np.zeros((B, max_quads, 8), np.float32)
    counts = np.zeros(B, np.int32)
    lib.quadproc_extract_batch(
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        B, H, W,
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_quads, min_area, ctypes.c_float(min_fill),
    )
    return quads.reshape(B, max_quads, 4, 2), counts


def extract_quad_stage(
    packed: np.ndarray,
    height: int,
    width: int,
    scale: int = 1,
    n_tags: int | None = None,
    max_quads: int = MAX_QUADS,
):
    """The detector's quad stage of one chunk, in one native call.

    Per frame: extract level-1 quads (``quadproc_extract``'s, from the
    packed bits) into ``max_quads // 2`` slots; where level 2 is needed (always without a
    board; with one, when level 1 found fewer than ``n_tags`` quads or one
    of at least (100 / scale)² px² of shoelace area) extract again from the
    bitmap dilated 3x3 in white; at scale 2 push the corners out from each
    quad's centre (1.5 px level 1, 2.75 px level 2); merge the levels
    (level-1 rows, then the level-2 rows whose centre lies farther than
    0.7x the mean corner radius from every level-1 quad's, then the
    others in the same order); at scale 2 map pyramid to full-resolution
    pixels (2x + 0.5).

    Args:
      packed: (C, Hp, row_bytes) uint8 host array, the threshold
        front-end's output: bits MSB first, 1 = white, rows and columns
        padded past the frame.
      height, width: the frames' size at the bitmap's scale.
      scale: 1, or 2 for a half-resolution pyramid level.
      n_tags: the board's tag count, or None without a board.

    Returns:
      quads: (C, max_quads, 4, 2) float32 full-resolution corners;
        rows past counts[c] hold the merge's invalid rows.
      counts: (C,) int32.
      level2: the number of frames that ran level 2.
    """
    lib = _load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    C, Hp, row_bytes = packed.shape
    if not (0 < height <= Hp and 0 < width <= 8 * row_bytes) or scale not in (1, 2):
        raise ValueError(f"extract_quad_stage: ({height}, {width}) at scale {scale} "
                         f"does not fit a {packed.shape} bitmap")
    quads = np.empty((C, max_quads, 4, 2), np.float32)
    counts = np.empty(C, np.int32)
    level2 = lib.quadstage_extract_batch(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        C, Hp, row_bytes, height, width, scale, -1 if n_tags is None else int(n_tags),
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_quads, MIN_AREA,
    )
    return quads, counts, level2


def refine_corners_native(
    images: np.ndarray,
    corners: np.ndarray,
    win: int = 4,
    iters: int = 6,
    counts: np.ndarray = None,
    group: int = 1,
) -> np.ndarray:
    """Native cornerSubPix-style refinement on the host (the math of
    ``detect/refine.py::refine_corners``; OpenMP over corners).

    Args:
      images: (B, H, W) float32 grayscale.
      corners: (B, M, 2) float32 initial positions.
      counts: optional (B,) — only the first counts[b]*group rows of image
        b are real; padding rows are skipped.
      group: corners per counted unit (4 for quads).

    Returns refined (B, M, 2) float32.
    """
    lib = _load()
    images = np.ascontiguousarray(images, dtype=np.float32)
    B, H, W = images.shape
    M = corners.shape[1]
    out = np.ascontiguousarray(corners, dtype=np.float32).copy()
    if counts is None:
        flat = out.reshape(-1, 2)
        idx = np.repeat(np.arange(B, dtype=np.int32), M)
    else:
        n_real = np.minimum(np.asarray(counts) * group, M)
        sel_b = np.repeat(np.arange(B), n_real)
        sel_m = np.concatenate([np.arange(n) for n in n_real]).astype(np.int64)
        flat = np.ascontiguousarray(out[sel_b, sel_m], dtype=np.float32)
        idx = sel_b.astype(np.int32)
    if flat.shape[0]:
        lib.refine_corners_native(
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            B, H, W,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flat.shape[0], win, iters,
        )
    if counts is None:
        return flat.reshape(B, M, 2)
    out[sel_b, sel_m] = flat
    return out


def refine_corners_patches_native(
    patches: np.ndarray, local: np.ndarray, win: int = 4, iters: int = 6
) -> np.ndarray:
    """Refine patch-local corner coordinates on the host (patches from
    ``detect.patches.extract_patches``).  patches: (n, P, P) float32;
    local: (n, 2) float32."""
    lib = _load()
    patches = np.ascontiguousarray(patches, dtype=np.float32)
    out = np.ascontiguousarray(local, dtype=np.float32).copy()
    n, P, _ = patches.shape
    if n:
        lib.refine_corners_patches(
            patches.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, P,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            win, iters,
        )
    return out
