"""Binding of the hand-written CUDA threshold kernel (``csrc/threshold.cu``).

The kernel replaces ``ccrs_tpu/ops/threshold_pallas.py::_kernel`` and fuses
all of ``threshold_front`` (pyramid pooling, white padding, adaptive
threshold, separation pass, bit packing) into one launch that allocates
nothing: the wrapper allocates only the output.  Its plain torch twin is
``ccrs_tpu_torch.detect.threshold.threshold_front_plain``.

The library is compiled with nvcc for ``sm_90a`` into
``ccrs_tpu_torch/_build/libccrs_kernels.so`` at first use (plain C entry
points, loaded with ctypes) and rebuilt when the source is newer; the
build's ``ptxas -v`` report (registers, shared memory, spills) is kept in
``_build/libccrs_kernels.ptxas.txt`` (``ptxas_report``).
``threshold_front_cuda.launches`` counts the calls that launched the
kernel, ``thread_launches()`` those of the calling thread.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..native_build import BUILD_DIR, ensure_built, nvcc_path

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "threshold.cu")
_SO = os.path.join(BUILD_DIR, "libccrs_kernels.so")
_LOG = os.path.join(BUILD_DIR, "libccrs_kernels.ptxas.txt")

_lock = threading.Lock()
_count_lock = threading.Lock()
#: thread ident -> launches made on that thread (see ``thread_launches``)
_by_thread: dict[int, int] = {}
_lib = None


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    cmd = [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", _SO, _SRC,
    ]
    return ensure_built(_SO, [_SRC], cmd, log_path=_LOG)


def ptxas_report() -> list[str]:
    """The per-kernel lines of the last build's ``ptxas -v`` output
    (registers, shared memory, spill stores and loads)."""
    if not os.path.exists(_LOG):
        return []
    with open(_LOG) as f:
        return [ln.strip() for ln in f if "spill" in ln or (
            "ptxas info" in ln and ("Used" in ln or "Compiling" in ln))]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        args = [
            ctypes.c_void_p, ctypes.c_void_p,  # in out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W
            ctypes.c_int, ctypes.c_float,  # scale min_contrast
            ctypes.c_void_p,  # cudaStream_t
        ]
        for fn in (lib.ccrs_threshold_front_u8, lib.ccrs_threshold_front_f32):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.ccrs_threshold_kernel_launches.argtypes = []
        lib.ccrs_threshold_kernel_launches.restype = ctypes.c_ulonglong
        lib.ccrs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ccrs_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def kernel_launches() -> int:
    """Kernels the library has launched in this process, counted in C
    where it launches them (each wrapper call launches exactly one)."""
    return int(_load().ccrs_threshold_kernel_launches())


def thread_launches() -> int:
    """Kernel launches made by the calling thread so far, counted where
    ``threshold_front_cuda`` launches.  A thread reads it before and after
    its work: the difference is its own launches, whatever other threads
    launch meanwhile."""
    with _count_lock:
        return _by_thread.get(threading.get_ident(), 0)


def threshold_front_cuda(images, scale: int = 1, tile: int = 4,
                         min_contrast: float = 20.0):
    """(B, H, W) uint8/float32 CUDA tensor -> packed (B, sH_pad, sW_pad/8)
    uint8 bitmap, sH = H // scale, sW = W // scale, rows padded to a
    multiple of 4 and columns of 8.  Raises on anything the kernel does not
    take; never falls back."""
    if not isinstance(images, torch.Tensor) or images.device.type != "cuda":
        raise ValueError("threshold_front_cuda needs a CUDA tensor")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"threshold_front_cuda: dtype {images.dtype} "
                        "(expected uint8 or float32)")
    if images.ndim != 3:
        raise ValueError(f"threshold_front_cuda: shape {tuple(images.shape)} "
                         "(expected (B, H, W))")
    if not images.is_contiguous():
        raise ValueError("threshold_front_cuda: input must be contiguous")
    if scale not in (1, 2) or tile != 4:
        raise ValueError(f"threshold_front_cuda: scale={scale} tile={tile} "
                         "(kernel takes scale 1 or 2, tile 4)")
    B, H, W = images.shape
    sH, sW = H // scale, W // scale
    if sH == 0 or sW == 0:
        raise ValueError(f"threshold_front_cuda: frame {H}x{W} too small")
    sHp = sH + (-sH) % 4
    sWp = sW + (-sW) % 8
    dev = images.device
    out = torch.empty((B, sHp, sWp // 8), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    lib = _load()
    fn = (lib.ccrs_threshold_front_u8 if images.dtype == torch.uint8
          else lib.ccrs_threshold_front_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(images.data_ptr(), out.data_ptr(), B, H, W, scale,
                float(min_contrast), stream)
    if rc != 0:
        msg = lib.ccrs_cuda_error_string(rc).decode()
        raise RuntimeError(f"threshold kernel launch failed: {msg} ({rc})")
    with _count_lock:  # the warm-up thread launches beside the main thread
        threshold_front_cuda.launches += 1
        threshold_front_cuda.launches_u8 += images.dtype == torch.uint8
        ident = threading.get_ident()
        _by_thread[ident] = _by_thread.get(ident, 0) + 1
    return out


threshold_front_cuda.launches = 0
#: how many of them took the kernel's uint8 path
threshold_front_cuda.launches_u8 = 0
