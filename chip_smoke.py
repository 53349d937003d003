#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ccrs_tpu_torch``) on one GPU.

Drives the port's cold detect -> calibrate path through the entry points a
user calls, at the benchmark's sizes:

- phase 512: 534 rendered 512x512 uint8 frames of a TUM-VI-like EUCM
  camera (the regime of the TUM-VI ``dataset-calib-cam1`` recording);
- phase 1024: 128 frames at 1024x1024 with the intrinsics scaled by 2,
  which runs the scale-2 pyramid branch of the threshold kernel;
- phase cli: the user's entry point.  A stereo EuRoC-layout dataset (2
  cameras x 640 frames at 752x480, EuRoC's cam0 UCM written as EUCM with
  beta = 1, the 11 cm rig of ``default_rig_extrinsics(2)``) is rendered on
  the card and written as PNG, then ``ccrs_tpu_torch.cli.main`` runs on it
  in-process with ``--platform cuda`` (PNG decode + upload, detection,
  per-camera calibration, joint BA, validation, artifacts; the default
  ``--max-images 600`` truncates after detection).

Phases 512 and 1024 run ``TagDetector.detect_batch`` ->
``FrameBatch.from_detections`` -> ``calibrate_camera_with_retries`` ->
``validation`` on the card and gate the result: focal error < 1%, median
reprojection < 0.3 px, and a float64 re-solve on the CPU from the card's
result must give the same RMS within 1e-6 px.  The cli phase gates fx
within 1% for both cameras, each median of ``report.txt`` below 0.3 px,
the extrinsic within 2e-3 of the rig, and a CPU float64 re-solve of the
joint BA from the card's result at the same RMS within 1e-6 px.  In every
phase the threshold kernel is held bit for bit against its plain torch
version on every frame (for cli: every decoded frame of both cameras) and
both are timed, and phases 512/1024 check the decode's tag ids against a
CPU run of the same frames.

Usage: ``python3 chip_smoke.py`` from the repository root (builds the CUDA
kernel, the host quad extractor and the PNG unfilter routine into
``ccrs_tpu_torch/_build/``; the cli phase's dataset lives in a temporary
directory that is removed at the end).
Prints a JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failed phase, and
when no CUDA device is available.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

N_512 = 534
N_1024 = 128
GT_512 = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
SEED = 11
TIMING_REPS = 10
N_CLI = 640
#: EuRoC cam0 (the reference example's UCM) written as EUCM with beta = 1
EUROC_CAM0 = [471.019, 470.243, 367.122, 246.741, 0.67485, 1.0]
#: pose spread of the cli dataset; at this scale 96% of the frames keep
#: >= 24 detected corners on the card (the phase fails below 80%)
SPAN_CLI = 1.5


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
    tag = f"[{H}x{W}] ({card})"
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


@contextlib.contextmanager
def observe_joint_solve(cli):
    """Record the arguments and result of the CLI's joint solve (the call
    still runs as the user's run makes it)."""
    real = cli.calib_all_camera_with_extrinsics
    seen = {}

    def wrapper(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        seen["result"] = real(*args, **kwargs)
        return seen["result"]

    cli.calib_all_camera_with_extrinsics = wrapper
    try:
        yield seen
    finally:
        cli.calib_all_camera_with_extrinsics = real


def run_cli_phase(card):
    """Render + write the stereo dataset, run the CLI on it, gate the
    artifacts, and re-solve the joint BA on the CPU from the card's result.
    Returns (decoded frames per camera, threshold launches of the CLI run)."""
    from ccrs_tpu_torch import cli
    from ccrs_tpu_torch.calib.multi import calib_all_camera_with_extrinsics
    from ccrs_tpu_torch.calib.validate import reprojection_errors
    from ccrs_tpu_torch.dataloader import _list_images
    from ccrs_tpu_torch.io import object_from_json
    from ccrs_tpu_torch.models import GenericModel, model_from_json
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.pngio import read_png
    from ccrs_tpu_torch.testdata import default_rig_extrinsics, write_euroc_dataset
    from ccrs_tpu_torch.types import RvecTvec
    from ccrs_tpu_torch.utils import profiling

    tag = f"[cli 2x{N_CLI}x752x480] ({card})"
    gt = GenericModel("eucm", EUROC_CAM0, 752, 480)
    rig = default_rig_extrinsics(2)
    profiling.enable()
    with tempfile.TemporaryDirectory(prefix="ccrs_chip_smoke_") as tmp:
        ds, out = os.path.join(tmp, "dataset"), os.path.join(tmp, "out")
        profiling.reset()
        write_euroc_dataset(
            ds, gt, n_frames=N_CLI, cam_num=2, extrinsics=rig, seed=SEED,
            noise=1.5, span_scale=SPAN_CLI, device="cuda",
        )
        stages = profiling.totals()
        profiling.reset()
        threshold_front_cuda.launches = 0  # count the CLI run's launches only
        cwd = os.getcwd()
        os.chdir(tmp)  # default_board_config.json goes to the cwd
        try:
            with observe_joint_solve(cli) as seen:
                # the CLI ends on host data (artifacts), so the card is idle
                # when it returns
                t0 = time.perf_counter()
                cli.main([
                    ds, "--model", "eucm", "--cam-num", "2", "--platform", "cuda",
                    "--no-rerun", "--seed", "1", "-o", out,
                ])
                t_cli = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = threshold_front_cuda.launches
        stages.update(profiling.totals())
        print(f"{tag} cli.main {t_cli:.3f} s; stage wall times:")
        for name, sec in stages.items():
            print(f"{tag}   {name:24s} {sec:8.3f} s")
        print(f"{tag} threshold kernel launches in the CLI run: {launches}")

        fx, medians = [], []
        for c in range(2):
            m = model_from_json(os.path.join(out, f"cam{c}.json"))
            fx.append(abs(m.params[0] - gt.params[0]) / gt.params[0])
            print(f"{tag} cam{c} {m.name} {np.array2string(m.params, precision=6)}")
        with open(os.path.join(out, "report.txt")) as f:
            report = f.read()
        medians = [float(v) for v in re.findall(r"median  reprojection error: ([0-9.]+) px", report)]
        ext = RvecTvec.from_json(object_from_json(os.path.join(out, "extrinsics.json"))["rtvecs"][1])
        ext_err = float(np.abs(np.concatenate([ext.rvec, ext.tvec]) - rig[1]).max())
        print(
            f"{tag} focal err {[f'{e:.4%}' for e in fx]}, medians {medians} px, "
            f"extrinsic max err {ext_err:.2e}"
        )
        if not (len(fx) == 2 and max(fx) < 0.01):
            raise RuntimeError(f"{tag} focal off by {fx}")
        if not (len(medians) == 2 and max(medians) < 0.3):
            raise RuntimeError(f"{tag} medians {medians} px")
        if not (ext_err < 2e-3):
            raise RuntimeError(f"{tag} extrinsic off the rig by {ext_err:.2e}")

        # interchange gate: a float64 joint re-solve on the CPU from the
        # card's result (same observations and frame sets) lands on the
        # same optimum
        board, _, _, rt_in, batches = seen["args"][:5]
        models, t_i_0, board_rt = seen["result"]
        usable = [float(b.frame_ok().mean()) for b in batches]
        print(f"{tag} usable frames (>= 24 corners): {usable}")
        if not min(usable) >= 0.8:
            raise RuntimeError(f"{tag} too few usable frames: {usable}")

        def rms(ms, t, brt):
            out_rms = []
            for c in range(len(ms)):
                rt = {f: t[c].compose(p) for f, p in brt.items()}
                errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batches[c], ms[c], rt)])
                out_rms.append(float(np.sqrt(np.mean(errs**2))))
            return out_rms

        card_rt = [{f: t_i_0[c].compose(board_rt[f]) for f in rt_in[c]} for c in range(2)]
        t1 = time.perf_counter()
        cpu = calib_all_camera_with_extrinsics(
            board, models, t_i_0, card_rt, batches, **seen["kwargs"] | {"device": "cpu"}
        )
        if cpu is None:
            raise RuntimeError(f"{tag} CPU float64 joint re-solve failed")
        rms_card, rms_cpu = rms(models, t_i_0, board_rt), rms(*cpu)
        drift = max(abs(a - b) for a, b in zip(rms_card, rms_cpu))
        print(
            f"{tag} CPU float64 joint re-solve: rms card {rms_card} px, "
            f"|rms_card - rms_cpu| = {drift:.3e} px ({time.perf_counter() - t1:.1f} s)"
        )
        if not (drift < 1e-6):
            raise RuntimeError(f"{tag} float64 interchange drift {drift:.3e} px")

        frames = []
        for c in range(2):
            paths = _list_images(os.path.join(ds, "mav0", f"cam{c}", "data", "*"), 0, 1)
            frames.append(np.stack([read_png(p) for p in paths]))
    return frames, launches


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
    import concurrent.futures as cf

    from ccrs_tpu_torch import pngio
    from ccrs_tpu_torch.detect import quads
    from ccrs_tpu_torch.detect.detector import CHUNK
    from ccrs_tpu_torch.ops import threshold_cuda

    def timed_build(build):
        t0 = time.perf_counter()
        path = build()
        return os.path.basename(path), time.perf_counter() - t0

    # one compiler per source, all started together
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(timed_build, b)
                  for b in (threshold_cuda.build, quads.build, pngio.build)]
        built = [f.result() for f in builds]
    print("built " + ", ".join(f"{name} in {sec:.1f} s" for name, sec in built)
          + " (nvcc sm_90a / g++, in parallel)")

    frames, scale, launches512 = run_phase(512, N_512, card)
    err512, ms512, plain512 = check_kernel(frames, scale, card)
    del frames
    frames, scale, launches1024 = run_phase(1024, N_1024, card)
    err1024, ms1024, plain1024 = check_kernel(frames, scale, card)
    del frames
    cli_frames, launches_cli = run_cli_phase(card)
    if launches_cli <= 0:
        raise RuntimeError("the CLI run never launched the threshold kernel")
    err_cli, ms_cli, plain_cli = 0, 0.0, 0.0
    for cam_frames in cli_frames:  # every decoded frame of both cameras
        e, ms, plain = check_kernel(torch.as_tensor(cam_frames).cuda(), 1, card)
        err_cli, ms_cli, plain_cli = max(err_cli, e), ms_cli + ms, plain_cli + plain
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [{
        "name": "threshold_front",
        "route": "cuda",
        "source": "ccrs_tpu_torch/csrc/threshold.cu",
        "replaces": "ccrs_tpu/ops/threshold_pallas.py:35",
        "launches": launches512 + launches1024 + launches_cli,
        "max_abs_err": max(err512, err1024, err_cli),
        "ms": ms512,
        "plain_ms": plain512,
        "shape": f"{N_512}x512x512 uint8, chunks of {CHUNK}",
        "ms_1024": ms1024,
        "plain_ms_1024": plain1024,
        "shape_1024": f"{N_1024}x1024x1024 uint8, chunks of {CHUNK}",
        "ms_752x480": ms_cli,
        "plain_ms_752x480": plain_cli,
        "shape_752x480": f"2 cameras x {N_CLI}x480x752 uint8, chunks of {CHUNK}",
        "launches_cli": launches_cli,
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
