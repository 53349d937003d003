#!/usr/bin/env python3
"""Where the CUDA threshold kernel spends its time, phase by phase.

Builds ``ccrs_tpu_torch/csrc/threshold.cu`` several times with nvcc
(``sm_90a``), each copy cut short at another point of its per-band work,
and times every copy under torch.profiler on the detector's chunks of 64
uint8 frames (half full-range random, half low-contrast):

- ``full``: the kernel as shipped (its output is checked bit for bit
  against ``threshold_front_plain``);
- ``copies``: the input copies alone (each band returns before its tile
  statistics);
- ``+stats``, ``+thresholds``, ``+masks``: cut after phase 1, 2 and 3;
- ``no copies``: every phase, but no input copied (the compute alone).

The cut copies compute garbage; only their times mean anything.  Prints
one line per copy and shape: mean kernel time over 20 launches, and the
share of the bound (input read once + output written once at 3.35 TB/s).

Usage, on a machine with an H100 and nvcc: ``python3 tools/threshold_phases.py``
(builds into a temporary directory, about half a minute).
"""

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ccrs_tpu_torch.detect.threshold import threshold_front_plain  # noqa: E402
from ccrs_tpu_torch.native_build import nvcc_path  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "ccrs_tpu_torch", "csrc", "threshold.cu")
CUT = "  if (g.H > 0) return;\n"
#: name -> (text in the source, text that replaces it)
VARIANTS = {
    "full": None,
    "copies": ("  // 1. tile statistics", CUT + "  // 1. tile statistics"),
    "+stats": ("  // 2. thresholds", CUT + "  // 2. thresholds"),
    "+thresholds": ("  // 3. binary masks", CUT + "  // 3. binary masks"),
    "+masks": ("  // 4. 3x3 OR", CUT + "  // 4. 3x3 OR"),
    "no copies": ("        cp_async16(dst, img + (size_t)R * g.W + Cc);",
                  "        if (g.H < 0) cp_async16(dst, img + (size_t)R * g.W + Cc);"),
}
#: (frames, height, width, scale): the detector's chunk at the three sizes
SHAPES = [(64, 512, 512, 1), (64, 1024, 1024, 2), (64, 480, 752, 1)]
REPS = 20
HBM_BYTES_PER_S = 3.35e12


def build(tmp, name, edit):
    with open(SRC) as f:
        src = f.read()
    if edit is not None:
        assert src.count(edit[0]) == 1, f"{name}: cut point not found"
        src = src.replace(edit[0], edit[1])
    path = os.path.join(tmp, name.replace(" ", "_").replace("+", "p"))
    with open(path + ".cu", "w") as f:
        f.write(src)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", path + ".so", path + ".cu"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(path + ".so")
    fn = lib.ccrs_threshold_front_u8
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return name, fn


def kernel_us(call):
    """Mean CUDA duration of the kernels torch.profiler saw over REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(us) / len(us) if us else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("threshold_phases: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for shape in SHAPES:
        x = torch.randint(0, 256, shape[:3], generator=gen, device="cuda", dtype=torch.uint8)
        x[1::2] = x[1::2] // 10 + 100  # low contrast: gray levels 100..125
        data[shape] = (x, threshold_front_plain(x, shape[3]))
    with tempfile.TemporaryDirectory(prefix="ccrs_threshold_phases_") as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(lambda kv: build(tmp, *kv), VARIANTS.items()))
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in built:
            for (B, H, W, scale), (x, want) in data.items():
                out = torch.empty_like(want)

                def call():
                    rc = fn(x.data_ptr(), out.data_ptr(), B, H, W, scale, 20.0, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                call()
                torch.cuda.synchronize()
                if name == "full" and not torch.equal(out, want):
                    raise RuntimeError(f"{B}x{H}x{W}: the kernel differs from the plain version")
                us = kernel_us(call)
                bound = (x.numel() + want.numel()) / HBM_BYTES_PER_S * 1e6
                print(f"{name:12s} {B}x{H}x{W} scale {scale}: {us:8.3f} us per chunk, "
                      f"bound {bound:.3f} us ({bound / us:.1%}) ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
