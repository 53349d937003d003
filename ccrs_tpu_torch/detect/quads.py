"""ctypes bridge to the native quad extractor.

The irregular stage of the detector (connected components, contours, quad
fit) stays host C++: ``ccrs_tpu/native/quadproc.cpp``, compiled with the
JAX package's g++ flags into the port's own ``ccrs_tpu_torch/_build/`` at
first use.  Nothing is written under ``ccrs_tpu/``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..native_build import BUILD_DIR, ensure_built

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "ccrs_tpu",
    "native", "quadproc.cpp",
)
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
        _SRC, "-o", _SO,
    ]
    return ensure_built(_SO, [_SRC], cmd)


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
