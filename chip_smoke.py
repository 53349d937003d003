#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ccrs_tpu_torch``) on one GPU.

Drives the port's cold detect -> calibrate path through the entry points a
user calls, at the benchmark's sizes:

- phase 512: 534 rendered 512x512 uint8 frames of a TUM-VI-like EUCM
  camera (the regime of the TUM-VI ``dataset-calib-cam1`` recording);
- phase 1024: 128 frames at 1024x1024 with the intrinsics scaled by 2,
  which runs the scale-2 pyramid branch of the threshold kernel.

Each phase runs ``TagDetector.detect_batch`` -> ``FrameBatch.from_detections``
-> ``calibrate_camera_with_retries`` -> ``validation`` on the card and
gates the result: focal error < 1%, median reprojection < 0.3 px, and a
float64 re-solve on the CPU from the card's result must give the same RMS
within 1e-6 px.  The threshold kernel is then held bit for bit against its
plain torch version on every frame, both are timed, and the decode's tag
ids are checked against a CPU run of the same frames.

Usage: ``python3 chip_smoke.py`` from the repository root (builds the CUDA
kernel and the host quad extractor into ``ccrs_tpu_torch/_build/``).
Prints a JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failed phase, and
when no CUDA device is available.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

N_512 = 534
N_1024 = 128
GT_512 = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
SEED = 11
TIMING_REPS = 10


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(torch, fn):
    """Run fn, synchronize the card, return (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def time_ms(torch, fn, reps=TIMING_REPS):
    """Milliseconds per call of fn on the card (CUDA events, warmed up)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_phase(size, n_frames, card):
    import torch

    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.calib import calib_camera, validation
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
    from ccrs_tpu_torch.calib.validate import reprojection_errors
    from ccrs_tpu_torch.detect import TagDetector, get_family
    from ccrs_tpu_torch.detect.detector import PYRAMID_MIN_SIDE
    from ccrs_tpu_torch.models import GenericModel, zeros_like_model
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses
    from ccrs_tpu_torch.types import CalibParams

    tag = f"[{size}] ({card})"
    s = size / 512.0
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    gt = GenericModel("eucm", [p * s for p in GT_512[:4]] + GT_512[4:], size, size)
    poses = smooth_sequence_poses(n_frames, board, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames, t_render = sync_time(torch, lambda: render_frames_device(
        gt, board, fam, poses, noise=1.5, generator=gen, device="cuda"
    ))
    print(f"{tag} rendered {tuple(frames.shape)} {frames.dtype} in {t_render:.3f} s")

    detector = TagDetector("t36h11", track=False, device="cuda")
    threshold_front_cuda.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    dets, t_detect = sync_time(
        torch, lambda: detector.detect_batch(None, board, dev_images=frames)
    )
    batch = FrameBatch.from_detections(dets, list(range(n_frames)), board, size, size)
    gen_calib = torch.Generator(device="cuda").manual_seed(1)
    (model, rtvecs), t_calib = sync_time(torch, lambda: calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(), gen_calib,
        device="cuda",
    ))
    with contextlib.redirect_stdout(sys.stderr):
        (avg99, median), t_valid = sync_time(
            torch, lambda: validation(board, batch, model, rtvecs)
        )
    t_total = time.perf_counter() - t0
    launches = threshold_front_cuda.launches
    n_tags = float(np.mean([len(d) for d in dets]))
    print(
        f"{tag} main path {t_total:.3f} s: detect {t_detect:.3f} s, "
        f"calibrate {t_calib:.3f} s, validation {t_valid:.3f} s; "
        f"{n_frames / t_total:.2f} frames/s"
    )
    print(f"{tag} threshold kernel launches in the main path: {launches}")
    if launches <= 0:
        raise RuntimeError(f"{tag} the main path never launched the threshold kernel")

    focal_err = abs(model.params[0] - gt.params[0]) / gt.params[0]
    print(
        f"{tag} tags/frame {n_tags:.2f}, focal err {focal_err:.4%}, "
        f"median {median:.4f} px, best-99% {avg99:.4f} px, "
        f"params {np.array2string(model.params, precision=6)}"
    )
    if not (focal_err < 0.01):
        raise RuntimeError(f"{tag} focal off by {focal_err:.2%}")
    if not (median < 0.3):
        raise RuntimeError(f"{tag} median reprojection {median:.4f} px")

    # interchange gate: a float64 re-solve on the CPU from the card's result
    # must land on the same optimum
    def rms_of(m, rt):
        errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, m, rt)])
        return float(np.sqrt(np.mean(errs**2)))

    t1 = time.perf_counter()
    cpu_res = calib_camera(
        board, batch, model, xy_same_focal=False, disabled_distortions=0,
        fixed_focal=False, device="cpu",
    )
    if cpu_res is None:
        raise RuntimeError(f"{tag} CPU float64 re-solve failed")
    drift = abs(rms_of(model, rtvecs) - rms_of(*cpu_res))
    print(
        f"{tag} CPU float64 re-solve: |rms_card - rms_cpu| = {drift:.3e} px "
        f"({time.perf_counter() - t1:.1f} s)"
    )
    if not (drift < 1e-6):
        raise RuntimeError(f"{tag} float64 interchange drift {drift:.3e} px")

    # decode ids on the card against the CPU path on a few frames (argmax
    # ties and the gather clips must behave alike)
    few = list(range(0, n_frames, max(1, n_frames // 4)))[:4]
    cpu_dets = TagDetector("t36h11", track=False, device="cpu").detect_batch(
        None, board, dev_images=frames[few].cpu()
    )
    for f, cd in zip(few, cpu_dets):
        if sorted(cd) != sorted(dets[f]):
            raise RuntimeError(f"{tag} frame {f}: card ids differ from CPU ids")
        for t in cd:
            err = float(np.abs(cd[t] - dets[f][t]).max())
            if not (err < 1e-3):
                raise RuntimeError(f"{tag} frame {f} tag {t}: corner diff {err} px")
    print(f"{tag} card decode matches the CPU path on frames {few}")
    return frames, 2 if size >= PYRAMID_MIN_SIDE else 1, launches


def check_kernel(frames, scale, card):
    """Kernel against its plain version on every frame, bit for bit, and
    the time of both over the whole sequence in main-path chunks."""
    import torch

    from ccrs_tpu_torch.detect.detector import CHUNK
    from ccrs_tpu_torch.detect.threshold import threshold_front_plain
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda

    B, H, W = frames.shape
    tag = f"[{H}] ({card})"
    max_err = 0
    for lo in range(0, B, CHUNK):
        part = frames[lo : lo + CHUNK].contiguous()
        got = threshold_front_cuda(part, scale)
        want = threshold_front_plain(part, scale)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise RuntimeError(f"{tag} kernel shape {got.shape} != {want.shape}")
        diff = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, diff)
        if diff != 0 or not torch.equal(got, want):
            raise RuntimeError(f"{tag} kernel differs from the plain version")
    print(f"{tag} threshold kernel == plain version bit for bit on all {B} frames")

    parts = [frames[lo : lo + CHUNK].contiguous() for lo in range(0, B, CHUNK)]
    ms = time_ms(torch, lambda: [threshold_front_cuda(p, scale) for p in parts])
    plain_ms = time_ms(torch, lambda: [threshold_front_plain(p, scale) for p in parts])
    print(
        f"{tag} threshold over {B}x{H}x{W} uint8 in chunks of {CHUNK}: "
        f"kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms"
    )
    return max_err, ms, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_label()
    print(card)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}"
    )
    from ccrs_tpu_torch.detect import quads
    from ccrs_tpu_torch.detect.detector import CHUNK
    from ccrs_tpu_torch.ops import threshold_cuda

    t0 = time.perf_counter()
    threshold_cuda.build()
    t1 = time.perf_counter()
    quads.build()
    t2 = time.perf_counter()
    print(
        f"built libccrs_kernels.so (nvcc sm_90a) in {t1 - t0:.1f} s, "
        f"libquadproc.so (g++) in {t2 - t1:.1f} s"
    )

    frames, scale, launches512 = run_phase(512, N_512, card)
    err512, ms512, plain512 = check_kernel(frames, scale, card)
    del frames
    frames, scale, launches1024 = run_phase(1024, N_1024, card)
    err1024, ms1024, plain1024 = check_kernel(frames, scale, card)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [{
        "name": "threshold_front",
        "route": "cuda",
        "source": "ccrs_tpu_torch/csrc/threshold.cu",
        "replaces": "ccrs_tpu/ops/threshold_pallas.py:35",
        "launches": launches512 + launches1024,
        "max_abs_err": max(err512, err1024),
        "ms": ms512,
        "plain_ms": plain512,
        "shape": f"{N_512}x512x512 uint8, chunks of {CHUNK}",
        "ms_1024": ms1024,
        "plain_ms_1024": plain1024,
        "shape_1024": f"{N_1024}x1024x1024 uint8, chunks of {CHUNK}",
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
