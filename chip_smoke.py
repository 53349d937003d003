#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ccrs_tpu_torch``) on one GPU.

Drives the port's default composition (wave-tracked detection plus
speculative calibration, as ``python -m ccrs_tpu`` runs it) through the
entry points a user calls, at the benchmark's sizes:

- phase 512: 534 rendered 512x512 uint8 frames of a TUM-VI-like EUCM
  camera (the regime of the TUM-VI ``dataset-calib-cam1`` recording);
- phase 1024: 128 frames at 1024x1024 with the intrinsics scaled by 2,
  which runs the scale-2 pyramid branch of the threshold kernel;

  each phase runs its main path once in a fresh state, then warm in turns
  with the cold composition (tracked, cold, cold, tracked), and phase 512
  once more under torch.profiler for the device's busy share;
- phase cli: the user's entry point.  A stereo EuRoC-layout dataset (2
  cameras x 640 frames at 752x480, EuRoC's cam0 UCM written as EUCM with
  beta = 1, the 11 cm rig of ``default_rig_extrinsics(2)``) is rendered on
  the card and written as PNG, then ``ccrs_tpu_torch.cli.main`` runs on it
  in-process with ``--platform cuda`` twice: the default composition on
  every frame (the default ``--max-images 600`` truncates after
  detection), and the cold composition (``CCRS_TRACK=0 --no-speculate
  --step 4``, 160 frames per camera);
- phase fresh: the user's real first run.  On the cli phase's dataset,
  ``python -m ccrs_tpu_torch <ds> --model eucm --cam-num 2 --platform cuda
  --no-rerun --seed 1`` as a SUBPROCESS, four times in turns with
  ``CCRS_PREWARM=1``, ``0``, ``1``, ``0``: each run's wall time from
  process start to exit, its "detecting feature took" line and stage
  timers; gates: exit code 0 on the card, ``cam0.json``, ``cam1.json`` and
  ``extrinsics.json`` byte for byte equal across the runs (warm-up changes
  timing, never results), fx within 1%, medians below 0.3 px, no warm-up
  or speculation error, the threshold kernel launched (by the run, and by
  the warm-up where it is on).  No gate on time;
- phase rig: ``bench_multicam.py``'s joint BA at its full size (8 cameras
  x 1000 frames, 36 tags x 4 corners, 0.75 visibility, 0.1 px noise),
  generated on the card (``testdata.rig_problem``), through
  ``ba_solve_multi`` (float64) and ``ba_solve_multi_mixed``, once each, and
  ``multi_ba_sharded_mixed`` on the mesh; gates per solve: focal
  < 3e-3, extrinsic < 3e-3, 0.07 < RMS < 0.13 px; mixed against float64
  RMS within 1e-6 px; sharded mixed against mixed theta within 1e-8
  relative; iterations (float32 stage + polish), seconds and peak device
  memory printed.  Then the 512 phase's final single-camera problem
  through ``ba_solve`` and ``ba_solve_mixed`` with float32 and float64
  polish Jacobians: RMS within 1e-6 px of each other;
- phase mesh: the multi-device layer on the mesh of every visible card
  (two shards of ``cuda:0`` when one is visible): the 512 phase's final
  EUCM problem through ``make_ba_solver`` against ``ba_solve`` (theta
  within 1e-9 relative, RMS within 1e-6 px), the cli phase's joint problem
  through the joint BA's sharded route (``multi_ba_sharded``) against its
  single-device route (theta and extrinsics within 1e-8, per-camera RMS
  within 1e-6 px) and a CPU float64 re-solve, and the first 128 frames of
  the 512 sequence through ``TagDetector(shard=True)``, tracked and cold,
  bit for bit against the unsharded detector, with the threshold kernel's
  launches per shard;
- phase undistort: EuRoC cam0's undistortion map from 752x480 to 1024x1024
  and the remap of one cli frame, on the card and on the CPU (maps within
  1e-3 px, pixels within 1 gray level), with their times;
- phase colour: the first 48 frames of the cli phase's cam0, tinted and
  written as 8-bit RGB PNGs, through ``load_euroc`` on the card, against
  the same frames turned to gray on the host by the loader's integer luma
  and written as gray PNGs: detections equal bit for bit, every threshold
  launch on the kernel's uint8 path;
- phase ccl: device quad extraction (``detect.ccl``, plain torch, not wired
  into the detector) on the kernel's bitmaps of 64 frames of the 512 phase
  and 16 of the 1024 phase: labels, quads and ``valid`` on the card equal
  to a CPU run's on 8 frames of each, the native quadproc's quads matched
  within 1.5 px (the unmatched share printed and gated), and the warm time
  of the chunk beside the host route's (bitmap download + quadproc) with
  the peak device memory;
- phase tools: ``python -m ccrs_tpu_torch.make_board`` as a subprocess (its
  PNG read back at the size it printed) and one host-rendered
  ``render_board_image`` frame detected on the card (>= 30 tags);
- phase bench: the port's two timing programs, each in a fresh process at
  full size, as a benchmark runs them: ``bench_torch.py`` (534 frames at
  512x512 and 128 at 1024x1024, with its host-image, CLI and CPU float64
  paths and gates) and ``bench_multicam_torch.py`` (8 cameras x 1000
  frames); each must exit 0 and end with one JSON line, which is printed,
  and ``bench_torch.py`` must report threshold kernel launches.

Phases 512 and 1024 run ``TagDetector("t36h11", device="cuda")``
(tracking on) with a ``SpeculativeCalib`` on its provisional hook ->
``FrameBatch.from_detections`` -> ``calibrate_camera_with_retries(...,
warm_provider=spec.take)`` -> ``validation`` on the card and gate the
result: focal error < 1%, median reprojection < 0.3 px, a float64
re-solve on the CPU from the card's result at the same RMS within 1e-6
px, the cold ladder on the same batch at the same RMS within 1e-6 px
(speculation changes timing, never results), tracked recall against the
cold detector on the card (missed pairs <= 5%, no tag missing for more
than cold_every + 4 frames, tracked total >= cold total), the cold
detector's ids on the card equal to the CPU's on 4 frames and the tracked
detector's on the first 48 frames (corners within 1e-3 px, equal stats),
and no recorded speculation error (nor audits without a speculation).
The cli runs gate fx within 1% for both cameras, each median of
``report.txt`` below 0.3 px, the extrinsic within 2e-3 of the rig, usable
frames >= 80%, a CPU float64 re-solve of the joint BA from the card's
result at the same RMS within 1e-6 px, and no speculation error.  In
every phase the threshold kernel is held bit for bit against its plain
torch version on every frame (for cli: every decoded frame of both
cameras) and both are timed over the whole sequence in the detector's
chunks of 64: the kernel by CUDA events around the loop of wrapper calls,
its device time by CUDA events around back-to-back launches (queued behind
a sleep kernel) and under torch.profiler (one launch per call, as the
library counts them, or the run fails), beside the bytes it must move and
the bound they give at the card's published 3.35 TB/s; every main-path
run (and each CLI run) must launch it.  The build prints the kernel's
``ptxas -v`` summary.

Usage: ``python3 chip_smoke.py`` from the repository root (builds the CUDA
kernel, the host quad extractor and the PNG unfilter routine into
``ccrs_tpu_torch/_build/``; the cli phase's dataset lives in a temporary
directory that is removed at the end).
Prints stage times, detector stats and gates per run, a JSON line of the
fresh and rig phases' numbers, one of the bench phase's two result lines,
a JSON line of kernel results, then as its last line ``{"ok": true,
"device": {...}}``.
Exits non-zero on any failed phase, and when no CUDA device is available.
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
#: seed of the calibration generator (RANSAC and retry draws)
CALIB_SEED = 1
TIMING_REPS = 10
#: passes over the sequence under torch.profiler for the kernel's device time
PROFILE_REPS = 3
#: cycles of the sleep kernel that holds the stream while the host queues
#: the launches timed back to back (about 0.1 s at the H100's clocks)
QUEUE_SLEEP_CYCLES = 200_000_000
#: published device-memory rate of the H100 SXM (HBM3), bytes/s
HBM_BYTES_PER_S = 3.35e12
N_CLI = 640
#: EuRoC cam0 (the reference example's UCM) written as EUCM with beta = 1
EUROC_CAM0 = [471.019, 470.243, 367.122, 246.741, 0.67485, 1.0]
#: pose spread of the cli dataset; at this scale 96% of the frames keep
#: >= 24 detected corners on the card (the phase fails below 80%)
SPAN_CLI = 1.5
#: frames of the 512 sequence the mesh phase detects sharded
N_MESH_DETECT = 128
#: cli cam0 frames the colour phase writes as RGB and as gray PNGs
N_COLOUR = 48
#: CCRS_PREWARM of the fresh phase's subprocess runs, in this order
FRESH_PREWARM = ("1", "0", "1", "0")
#: bench_multicam.py's rig: cameras, frames per camera, visibility of cameras > 0
RIG = dict(n_cams=8, n_frames=1000, vis_frac=0.75)
#: the bench phase's programs (each in a fresh process, at full size) and
#: the seconds each may take
BENCH_PROGRAMS = (("bench_torch.py", 600), ("bench_multicam_torch.py", 300))
#: frames per shape the ccl phase extracts on the card, and of those on the CPU
N_CCL = {512: 64, 1024: 16}
N_CCL_CPU = 8
#: candidate capacity per frame in the ccl phase, device and native route
CCL_MAX_QUADS = 128
#: native quads without a device quad within 1.5 px: most a run may show.
#: The CPU tests measure 0 to 31% per rendered frame (irregular blobs whose
#: hull touchpoints lie off the native line fits; the decoder rejects them)
CCL_MAX_UNMATCHED = 0.35


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


def main_path(size, n_frames, frames, board, card, label, track=True):
    """The port's default composition, as a user calls it: the tracked
    detector with a SpeculativeCalib on its provisional hook ->
    FrameBatch -> the retry ladder warm-started from the speculation ->
    validation, all on the card.  ``track=False`` runs the cold
    composition instead (``CCRS_TRACK=0 --no-speculate``: the cold
    detector and the cold ladder).  The threshold launch count and the
    stage timers are reset just before and read just after."""
    import torch

    from ccrs_tpu_torch.calib import validation
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.models import zeros_like_model
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.types import CalibParams
    from ccrs_tpu_torch.utils import profiling

    times = list(range(n_frames))
    if track:
        detector = TagDetector("t36h11", device="cuda")  # tracking is the default
        if not detector.track:
            raise RuntimeError(f"{label} the detector does not track by default")
    else:
        detector = TagDetector("t36h11", track=False, device="cuda")
    detector.reset_tracking()
    gen = torch.Generator(device="cuda").manual_seed(CALIB_SEED)
    spec = SpeculativeCalib(board, times, zeros_like_model("eucm"), CalibParams(), gen, size, size)
    detector.on_provisional = spec.on_provisional if track else None
    profiling.reset()
    threshold_front_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets, t_detect = sync_time(
        torch, lambda: detector.detect_batch(None, board, dev_images=frames)
    )
    batch = FrameBatch.from_detections(dets, times, board, size, size)
    (model, rtvecs), t_calib = sync_time(torch, lambda: calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(), gen,
        warm_provider=spec.take if track else None, device="cuda",
    ))
    warm_offered = calibrate_camera_with_retries.last_warm_offered
    spec_used = calibrate_camera_with_retries.last_spec_used
    with contextlib.redirect_stdout(sys.stderr):
        (avg99, median), t_valid = sync_time(
            torch, lambda: validation(board, batch, model, rtvecs)
        )
    t_total = time.perf_counter() - t0
    launches = threshold_front_cuda.launches
    stages = profiling.totals()
    print(
        f"{label} main path {t_total:.3f} s: detect {t_detect:.3f} s, "
        f"calibrate {t_calib:.3f} s, validation {t_valid:.3f} s; "
        f"{n_frames / t_total:.2f} frames/s; threshold kernel launches {launches}"
    )
    stats = {k: detector.stats.get(k, 0) for k in
             ("frames", "cold_frames", "cold_groups", "trigger_frames", "waves", "resweeps")}
    if track:
        print(
            f"{label} detector stats {stats}; speculation started {spec.started}, "
            f"error {spec.error}; last_warm_offered {warm_offered}, "
            f"last_spec_used {spec_used}"
        )
    print(f"{label} stage wall times (spec/ stages overlap the main thread):")
    for name in sorted(stages, key=lambda k: -stages[k]):
        print(f"{label}   {name:26s} {stages[name]:8.3f} s")
    if launches <= 0:
        raise RuntimeError(f"{label} the main path never launched the threshold kernel")
    if spec.error is not None or "provisional_error" in detector.stats:
        raise RuntimeError(
            f"{label} speculation failed: {spec.error or detector.stats['provisional_error']}"
        )
    if stats["trigger_frames"] > 0 and not (spec.started and warm_offered):
        raise RuntimeError(f"{label} audits ran but the speculation never started")
    return dict(dets=dets, batch=batch, model=model, rtvecs=rtvecs, median=median,
                avg99=avg99, launches=launches, t_total=t_total, stats=stats,
                stages=stages)


def rms_of(board, batch, model, rtvecs):
    from ccrs_tpu_torch.calib.validate import reprojection_errors

    errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, model, rtvecs)])
    return float(np.sqrt(np.mean(errs**2)))


def same_detections(got, want, label, what):
    """Ids exact per frame, corners within 1e-3 px."""
    for f, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            raise RuntimeError(f"{label} {what}: frame {f} ids differ: {set(g) ^ set(w)}")
        for t in g:
            err = float(np.abs(g[t] - w[t]).max())
            if not (err < 1e-3):
                raise RuntimeError(f"{label} {what}: frame {f} tag {t} corner diff {err} px")


def recall_gate(tracked, cold, cold_every, label):
    """The recall guarantee of tests/test_track.py against the cold path:
    missed (frame, tag) pairs <= 5% of the cold path's, no tag missing for
    more than cold_every + 4 frames in a row, tracked total >= cold total."""
    run_len, worst, n_missed, n_cold = {}, 0, 0, 0
    for c, t in zip(cold, tracked):
        n_cold += len(c)
        m = set(c) - set(t)
        n_missed += len(m)
        for tid in list(run_len):
            if tid not in m:
                run_len.pop(tid)
        for tid in m:
            run_len[tid] = run_len.get(tid, 0) + 1
            worst = max(worst, run_len[tid])
    n_trk = sum(len(t) for t in tracked)
    print(
        f"{label} recall against the cold path: tracked {n_trk} (frame, tag) pairs, "
        f"cold {n_cold}, missed {n_missed} ({n_missed / max(n_cold, 1):.2%}), "
        f"longest missing run {worst} frames"
    )
    if not (n_missed <= 0.05 * n_cold and worst <= cold_every + 4 and n_trk >= n_cold):
        raise RuntimeError(f"{label} tracked recall below the cold path's")


def device_busy_share(torch, fn):
    """Run fn under torch.profiler: (device busy seconds from the CUDA
    kernel and copy events, wall seconds of the profiled run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(torch, fn)
    busy_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    return busy_us / 1e6, wall


def run_phase(size, n_frames, card):
    import torch

    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.calib import calib_camera
    from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
    from ccrs_tpu_torch.detect import TagDetector, get_family
    from ccrs_tpu_torch.detect.detector import PYRAMID_MIN_SIDE
    from ccrs_tpu_torch.models import GenericModel, zeros_like_model
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

    run = main_path(size, n_frames, frames, board, card, tag)
    launches = [run["launches"]]
    model, rtvecs, batch, dets = run["model"], run["rtvecs"], run["batch"], run["dets"]
    n_tags = float(np.mean([len(d) for d in dets]))
    focal_err = abs(model.params[0] - gt.params[0]) / gt.params[0]
    print(
        f"{tag} tags/frame {n_tags:.2f}, focal err {focal_err:.4%}, "
        f"median {run['median']:.4f} px, best-99% {run['avg99']:.4f} px, "
        f"params {np.array2string(model.params, precision=6)}"
    )
    if not (focal_err < 0.01):
        raise RuntimeError(f"{tag} focal off by {focal_err:.2%}")
    if not (run["median"] < 0.3):
        raise RuntimeError(f"{tag} median reprojection {run['median']:.4f} px")

    # interchange gate: a float64 re-solve on the CPU from the card's result
    # must land on the same optimum
    t1 = time.perf_counter()
    cpu_res = calib_camera(
        board, batch, model, xy_same_focal=False, disabled_distortions=0,
        fixed_focal=False, device="cpu",
    )
    if cpu_res is None:
        raise RuntimeError(f"{tag} CPU float64 re-solve failed")
    rms_card = rms_of(board, batch, model, rtvecs)
    drift = abs(rms_card - rms_of(board, batch, *cpu_res))
    print(
        f"{tag} CPU float64 re-solve: |rms_card - rms_cpu| = {drift:.3e} px "
        f"({time.perf_counter() - t1:.1f} s)"
    )
    if not (drift < 1e-6):
        raise RuntimeError(f"{tag} float64 interchange drift {drift:.3e} px")

    # speculation changes timing, never results: the cold ladder (no warm
    # start, a generator with the same seed) on the same batch
    (m_cold, rt_cold), t_cold = sync_time(torch, lambda: calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(),
        torch.Generator(device="cuda").manual_seed(CALIB_SEED), device="cuda",
    ))
    spec_gap = abs(rms_card - rms_of(board, batch, m_cold, rt_cold))
    print(
        f"{tag} cold ladder on the same batch ({t_cold:.3f} s): "
        f"|rms_spec - rms_cold| = {spec_gap:.3e} px"
    )
    if not (spec_gap < 1e-6):
        raise RuntimeError(f"{tag} the speculative result left the cold optimum by {spec_gap:.3e} px")

    # recall of the tracked path against the cold detector on the card
    cold_det = TagDetector("t36h11", track=False, device="cuda")
    cold, t_colddet = sync_time(torch, lambda: cold_det.detect_batch(None, board, dev_images=frames))
    print(f"{tag} cold detector on the card: {t_colddet:.3f} s")
    recall_gate(dets, cold, TagDetector("t36h11").cold_every, tag)

    # the card against the CPU: the cold detector on a few frames, and the
    # tracked detector on the first 48 frames (ids, corners and stats)
    few = list(range(0, n_frames, max(1, n_frames // 4)))[:4]
    cpu_cold = TagDetector("t36h11", track=False, device="cpu").detect_batch(
        None, board, dev_images=frames[few].cpu()
    )
    same_detections([cold[f] for f in few], cpu_cold, tag, "cold card vs CPU")
    n48 = min(48, n_frames)
    trk_card, trk_cpu = TagDetector("t36h11", device="cuda"), TagDetector("t36h11", device="cpu")
    got = trk_card.detect_batch(None, board, dev_images=frames[:n48])
    t1 = time.perf_counter()
    want = trk_cpu.detect_batch(None, board, dev_images=frames[:n48].cpu())
    same_detections(got, want, tag, "tracked card vs CPU")
    if trk_card.stats != trk_cpu.stats:
        raise RuntimeError(f"{tag} tracked stats differ: card {trk_card.stats} cpu {trk_cpu.stats}")
    print(
        f"{tag} card decode matches the CPU path: cold on frames {few}, tracked on "
        f"frames 0..{n48 - 1} with equal stats ({time.perf_counter() - t1:.1f} s on the CPU)"
    )

    # warm runs in this process (first-call set-up paid): the default
    # composition against the cold one in turns (default, cold, cold,
    # default), so both see the same card and host
    walls = {True: [], False: []}
    for track in (True, False, False, True):
        name = "tracked" if track else "cold composition"
        warm = main_path(size, n_frames, frames, board, card,
                         f"[{size} warm, {name}] ({card})", track=track)
        walls[track].append(warm["t_total"])
        if track:
            launches.append(warm["launches"])
    print(
        f"[{size} warm] ({card}) main path, tracked + speculative: "
        f"{', '.join(f'{t:.3f}' for t in walls[True])} s; cold composition: "
        f"{', '.join(f'{t:.3f}' for t in walls[False])} s"
    )
    if size == 512:
        # once more under torch.profiler: the device's busy share
        busy, wall = device_busy_share(
            torch, lambda: launches.append(
                main_path(size, n_frames, frames, board, card, f"[{size} profiled] ({card})")["launches"]
            )
        )
        print(
            f"[{size} profiled] ({card}) device busy {busy:.3f} s of {wall:.3f} s wall "
            f"= {busy / wall:.1%} (torch.profiler CUDA events / wall, profiler on)"
        )
        if busy <= 0:
            print(f"[{size} profiled] ({card}) device time not measured: the profiler showed none")
    return frames, 2 if size >= PYRAMID_MIN_SIDE else 1, sum(launches), run


def kernel_device_ms(torch, parts, scale):
    """The threshold kernel's device time per pass over ``parts``: the mean
    CUDA duration of its kernels under torch.profiler (PROFILE_REPS passes)
    times the calls of a pass, and the kernels the profiler saw per pass
    (it may miss some; more than one per call fails the run).  (None, 0)
    when it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ccrs_tpu_torch.ops.threshold_cuda import kernel_launches, threshold_front_cuda

    for p in parts:  # warm
        threshold_front_cuda(p, scale)
    torch.cuda.synchronize()
    launched = kernel_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            for p in parts:
                threshold_front_cuda(p, scale)
        torch.cuda.synchronize()
    calls = PROFILE_REPS * len(parts)
    if kernel_launches() - launched != calls:
        raise RuntimeError(f"{kernel_launches() - launched} kernel launches for {calls} calls")
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "threshold_kernel" in e.name]
    if len(events) > calls:
        raise RuntimeError(f"the profiler saw {len(events)} kernels for {calls} calls")
    if not events:
        return None, 0
    mean_us = sum(e.time_range.elapsed_us() for e in events) / len(events)
    return mean_us * len(parts) / 1e3, len(events) / PROFILE_REPS


def kernel_events_ms(torch, parts, scale):
    """The threshold kernel's device time per pass over ``parts``, by CUDA
    events around TIMING_REPS passes of back-to-back launches: a sleep
    kernel holds the stream while the host queues every launch, so the
    card runs them one after the other and the events see no host gap
    (fails if the sleep ended before the host finished queuing)."""
    from ccrs_tpu_torch.ops.threshold_cuda import kernel_launches, threshold_front_cuda

    for p in parts:  # warm
        threshold_front_cuda(p, scale)
    torch.cuda.synchronize()
    launched = kernel_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(TIMING_REPS):
        for p in parts:
            threshold_front_cuda(p, scale)
    end.record()
    queued_in_time = not start.query()
    torch.cuda.synchronize()
    calls = TIMING_REPS * len(parts)
    if kernel_launches() - launched != calls:
        raise RuntimeError(f"{kernel_launches() - launched} kernel launches for {calls} calls")
    if not queued_in_time:
        raise RuntimeError("the sleep kernel ended before the launches were queued")
    return start.elapsed_time(end) / TIMING_REPS


def check_kernel(frames, scale, card, label):
    """Kernel against its plain version on every frame, bit for bit; the
    time of both over the whole sequence in main-path chunks (CUDA events
    around the loop of calls, wrapper included), the kernel's device time
    (CUDA events around back-to-back launches; torch.profiler's beside it),
    and the bytes it must move with the bound they give."""
    import torch

    from ccrs_tpu_torch.detect.detector import CHUNK
    from ccrs_tpu_torch.detect.threshold import threshold_front_plain
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda

    B, H, W = frames.shape
    tag = f"[{label}] ({card})"
    max_err, out_bytes = 0, 0
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
        out_bytes += got.numel()
    print(f"{tag} threshold kernel == plain version bit for bit on all {B} frames")

    parts = [frames[lo : lo + CHUNK].contiguous() for lo in range(0, B, CHUNK)]
    ms = time_ms(torch, lambda: [threshold_front_cuda(p, scale) for p in parts])
    plain_ms = time_ms(torch, lambda: [threshold_front_plain(p, scale) for p in parts])
    device_ms = kernel_events_ms(torch, parts, scale)
    profiler_ms, per_pass = kernel_device_ms(torch, parts, scale)
    in_bytes = frames.numel() * frames.element_size()
    n_bytes = in_bytes + out_bytes
    bound_us = n_bytes / HBM_BYTES_PER_S * 1e6
    share = bound_us / (device_ms * 1e3)
    print(
        f"{tag} threshold over {B}x{H}x{W} {frames.dtype} (scale {scale}) in {len(parts)} "
        f"chunks of {CHUNK}: kernel {ms:.4f} ms (CUDA events around the calls), "
        f"plain torch {plain_ms:.4f} ms"
    )
    print(
        f"{tag} kernel device time {device_ms * 1e3:.3f} us per pass (CUDA events around "
        f"{TIMING_REPS} passes of back-to-back launches, {len(parts)} per pass); bytes "
        f"{n_bytes} (in {in_bytes}, out {out_bytes}), bound {bound_us:.3f} us at 3.35 TB/s, "
        f"{share:.1%} of the bound"
    )
    if profiler_ms is None:
        print(f"{tag} torch.profiler device time not measured: it showed no kernel")
    else:
        print(
            f"{tag} torch.profiler device time {profiler_ms * 1e3:.3f} us per pass (mean of "
            f"the {per_pass:g} kernels it saw per pass x {len(parts)} calls)"
        )
    return dict(shape=f"{label} {frames.dtype}, scale {scale}, chunks of {CHUNK}",
                frames=B, bytes=n_bytes, bound_us=bound_us, device_ms=device_ms,
                profiler_ms=profiler_ms, bound_share=share, ms=ms, plain_ms=plain_ms,
                max_abs_err=max_err)


def ptxas_summary():
    """One line per kernel instantiation of the last build's ptxas -v
    report: registers, stack frame, spills."""
    from ccrs_tpu_torch.ops import threshold_cuda

    lines, name = [], None
    for ln in threshold_cuda.ptxas_report():
        m = re.search(r"threshold_kernelI([hf])Li(\d)E", ln)
        if "Compiling entry function" in ln and m:
            name = f"threshold_kernel<{'uint8' if m.group(1) == 'h' else 'float32'}, scale {m.group(2)}>"
        elif name is not None and ("Used" in ln or "spill" in ln):
            lines.append(f"{name}: {ln.replace('ptxas info    : ', '')}")
    return lines


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


@contextlib.contextmanager
def observe_specs(cli):
    """Record every SpeculativeCalib the CLI makes (one per camera)."""
    real = cli.SpeculativeCalib
    made = []

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    cli.SpeculativeCalib = Recorded
    try:
        yield made
    finally:
        cli.SpeculativeCalib = real


@contextlib.contextmanager
def observe_detector_stats(cli):
    """Record the stats of every tracked batch the CLI's detector runs (one
    per camera: the detector assigns a fresh stats dict per batch)."""
    real = cli.TagDetector
    seen = []

    class Recorded(real):
        @property
        def stats(self):
            return self._stats

        @stats.setter
        def stats(self, value):
            self._stats = value
            seen.append(value)

    cli.TagDetector = Recorded
    try:
        yield seen
    finally:
        cli.TagDetector = real


@contextlib.contextmanager
def env_set(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(tmp, name, ds, gt, rig, label, extra, env):
    """One ``cli.main`` run on the dataset, then its gates: fx and medians,
    the extrinsic against the rig, usable frames, and a CPU float64 joint
    re-solve from the card's result.  Returns the threshold launches of
    the run and the observed joint solve (arguments and result)."""
    from ccrs_tpu_torch import cli
    from ccrs_tpu_torch.io import object_from_json
    from ccrs_tpu_torch.models import model_from_json
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.types import RvecTvec
    from ccrs_tpu_torch.utils import profiling

    out = os.path.join(tmp, name)
    profiling.reset()
    threshold_front_cuda.launches = 0  # count this CLI run's launches only
    cwd = os.getcwd()
    os.chdir(tmp)  # default_board_config.json goes to the cwd
    try:
        # this process is warm by now, so the CLI's warm-up thread would only
        # compete with the first chunk (and add its launch to the count):
        # the fresh phase runs it where it belongs
        with env_set(CCRS_PREWARM="0", **env), observe_joint_solve(cli) as seen, \
                observe_specs(cli) as specs, observe_detector_stats(cli) as det_stats:
            # the CLI ends on host data (artifacts), so the card is idle
            # when it returns
            t0 = time.perf_counter()
            cli.main([
                ds, "--model", "eucm", "--cam-num", "2", "--platform", "cuda",
                "--no-rerun", "--seed", "1", "-o", out,
            ] + extra)
            t_cli = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = threshold_front_cuda.launches
    stages = profiling.totals()
    print(f"{label} cli.main {t_cli:.3f} s; stage wall times (spec/ stages overlap):")
    for name in sorted(stages):
        print(f"{label}   {name:26s} {stages[name]:8.3f} s")
    print(f"{label} threshold kernel launches in the CLI run: {launches}")
    for c, st in enumerate(s for s in det_stats if "frames" in s):
        print(f"{label} cam{c} detector stats "
              f"{ {k: v for k, v in st.items() if k != 'trigger_log'} }")
        if "provisional_error" in st:
            raise RuntimeError(f"{label} cam{c} provisional hook failed: {st['provisional_error']}")
    for c, spec in enumerate(specs):
        print(
            f"{label} cam{c} speculation started {spec.started}, warm seed "
            f"{spec.take() is not None}, error {spec.error}"
        )
        if spec.error is not None:
            raise RuntimeError(f"{label} cam{c} speculation failed: {spec.error}")
    if "--no-speculate" in extra and specs:
        raise RuntimeError(f"{label} --no-speculate still speculated")
    if launches <= 0:
        raise RuntimeError(f"{label} the CLI run never launched the threshold kernel")

    fx = []
    for c in range(2):
        m = model_from_json(os.path.join(out, f"cam{c}.json"))
        fx.append(abs(m.params[0] - gt.params[0]) / gt.params[0])
        print(f"{label} cam{c} {m.name} {np.array2string(m.params, precision=6)}")
    with open(os.path.join(out, "report.txt")) as f:
        report = f.read()
    medians = [float(v) for v in re.findall(r"median  reprojection error: ([0-9.]+) px", report)]
    ext = RvecTvec.from_json(object_from_json(os.path.join(out, "extrinsics.json"))["rtvecs"][1])
    ext_err = float(np.abs(np.concatenate([ext.rvec, ext.tvec]) - rig[1]).max())
    print(
        f"{label} focal err {[f'{e:.4%}' for e in fx]}, medians {medians} px, "
        f"extrinsic max err {ext_err:.2e}"
    )
    if not (len(fx) == 2 and max(fx) < 0.01):
        raise RuntimeError(f"{label} focal off by {fx}")
    if not (len(medians) == 2 and max(medians) < 0.3):
        raise RuntimeError(f"{label} medians {medians} px")
    if not (ext_err < 2e-3):
        raise RuntimeError(f"{label} extrinsic off the rig by {ext_err:.2e}")

    # interchange gate: a float64 joint re-solve on the CPU from the card's
    # result (same observations and frame sets) lands on the same optimum
    batches = seen["args"][4]
    usable = [float(b.frame_ok().mean()) for b in batches]
    print(f"{label} usable frames (>= 24 corners): {usable}")
    if not min(usable) >= 0.8:
        raise RuntimeError(f"{label} too few usable frames: {usable}")

    cpu_joint_gate(seen, seen["result"], label)
    return launches, seen


def joint_rms(board, batches, models, t_i_0, board_rt):
    """Per-camera RMS reprojection error of a joint result."""
    from ccrs_tpu_torch.calib.validate import reprojection_errors

    out = []
    for c in range(len(models)):
        rt = {f: t_i_0[c].compose(p) for f, p in board_rt.items()}
        errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batches[c], models[c], rt)])
        out.append(float(np.sqrt(np.mean(errs**2))))
    return out


def cpu_joint_gate(seen, result, label):
    """A float64 joint re-solve on the CPU from ``result`` (same
    observations and frame sets as the observed call) lands at the same
    per-camera RMS within 1e-6 px."""
    from ccrs_tpu_torch.calib.multi import calib_all_camera_with_extrinsics

    board, _, _, rt_in, batches = seen["args"][:5]
    models, t_i_0, board_rt = result
    card_rt = [{f: t_i_0[c].compose(board_rt[f]) for f in rt_in[c]} for c in range(len(models))]
    t1 = time.perf_counter()
    cpu = calib_all_camera_with_extrinsics(
        board, models, t_i_0, card_rt, batches, **seen["kwargs"] | {"device": "cpu"}
    )
    if cpu is None:
        raise RuntimeError(f"{label} CPU float64 joint re-solve failed")
    rms_card = joint_rms(board, batches, models, t_i_0, board_rt)
    rms_cpu = joint_rms(board, batches, *cpu)
    drift = max(abs(a - b) for a, b in zip(rms_card, rms_cpu))
    print(
        f"{label} CPU float64 joint re-solve: rms card {rms_card} px, "
        f"|rms_card - rms_cpu| = {drift:.3e} px ({time.perf_counter() - t1:.1f} s)"
    )
    if not (drift < 1e-6):
        raise RuntimeError(f"{label} float64 interchange drift {drift:.3e} px")


def run_cli_phase(card):
    """Render + write the stereo dataset, then run the CLI on it twice: the
    default composition (tracked detection, speculative calibration) on
    every frame, and the cold composition (CCRS_TRACK=0, --no-speculate)
    on every 4th frame.  Returns (decoded frames per camera, threshold
    launches of both CLI runs, the default run's joint solve)."""
    from ccrs_tpu_torch.dataloader import _list_images
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.pngio import read_png
    from ccrs_tpu_torch.testdata import default_rig_extrinsics, write_euroc_dataset
    from ccrs_tpu_torch.utils import profiling

    gt = GenericModel("eucm", EUROC_CAM0, 752, 480)
    rig = default_rig_extrinsics(2)
    with tempfile.TemporaryDirectory(prefix="ccrs_chip_smoke_") as tmp:
        ds = os.path.join(tmp, "dataset")
        profiling.reset()
        write_euroc_dataset(
            ds, gt, n_frames=N_CLI, cam_num=2, extrinsics=rig, seed=SEED,
            noise=1.5, span_scale=SPAN_CLI, device="cuda",
        )
        for name, sec in profiling.totals().items():
            print(f"[cli dataset] ({card}) {name:26s} {sec:8.3f} s")
        launches, joint = run_cli(
            tmp, "out", ds, gt, rig, f"[cli 2x{N_CLI}x752x480] ({card})", [], {}
        )
        launches += run_cli(
            tmp, "out_cold", ds, gt, rig, f"[cli cold 2x{N_CLI // 4}x752x480] ({card})",
            ["--no-speculate", "--step", "4"], {"CCRS_TRACK": "0"},
        )[0]
        fresh = run_fresh_phase(tmp, ds, gt, card)
        frames = []
        for c in range(2):
            paths = _list_images(os.path.join(ds, "mav0", f"cam{c}", "data", "*"), 0, 1)
            frames.append(np.stack([read_png(p) for p in paths]))
    return frames, launches, joint, fresh


def run_fresh_phase(tmp, ds, gt, card):
    """The CLI as a user starts it: a new process per run, on the cli
    phase's dataset, with the warm-up on and off in turns.  Returns one
    record per run (wall seconds, the lines it printed about itself, its
    threshold launches)."""
    from ccrs_tpu_torch.models import model_from_json

    root = os.path.dirname(os.path.abspath(__file__))
    runs, first = [], None
    for i, prewarm in enumerate(FRESH_PREWARM):
        tag = f"[fresh {i}, CCRS_PREWARM={prewarm}] ({card})"
        out = os.path.join(tmp, f"fresh{i}")
        env = dict(os.environ)
        env.update(CCRS_PREWARM=prewarm, CCRS_TIMING="1",
                   PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
        env.pop("CCRS_TRACK", None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ccrs_tpu_torch", ds, "--model", "eucm", "--cam-num", "2",
             "--platform", "cuda", "--no-rerun", "--seed", "1", "-o", out],
            capture_output=True, text=True, env=env, cwd=tmp, timeout=600,
        )
        wall = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} exited {proc.returncode}: {text[-3000:]}")
        if "device: cuda" not in proc.stdout:
            raise RuntimeError(f"{tag} did not run on the card: {proc.stdout[:300]}")
        for word in ("prewarm error", "speculation error", "prewarm failed",
                     "speculative calibration failed", "Traceback"):
            if word in text:
                raise RuntimeError(f"{tag} reported '{word}': {text[-3000:]}")
        detect = re.search(r"detecting feature took ([0-9.]+) sec", proc.stdout)
        warm = re.search(r"prewarm took ([0-9.]+) sec", proc.stdout)
        count = re.search(r"threshold kernel launches: (\d+) \(prewarm (\d+)\)", proc.stdout)
        if not (detect and count):
            raise RuntimeError(f"{tag} printed no detection time or launch count")
        total, by_warmup = int(count.group(1)), int(count.group(2))
        if (warm is not None) != (prewarm == "1") or (by_warmup > 0) != (prewarm == "1"):
            raise RuntimeError(f"{tag} warm-up ran {warm is not None} with {by_warmup} launches")
        if total - by_warmup <= 0:
            raise RuntimeError(f"{tag} the run never launched the threshold kernel")
        stages = dict(
            (m.group(1), float(m.group(2)))
            for m in re.finditer(r"^  (\S+)\s+([0-9.]+)s  x\d+$", proc.stdout, re.M)
        )
        print(f"{tag} wall {wall:.3f} s from process start to exit; detecting feature took "
              f"{float(detect.group(1)):.3f} s; prewarm "
              f"{'took ' + warm.group(1) + ' s' if warm else 'off'}; threshold kernel launches "
              f"{total} ({by_warmup} by the warm-up)")
        for name in sorted(stages, key=lambda k: -stages[k]):
            print(f"{tag}   {name:26s} {stages[name]:8.3f} s")

        files = {}
        for name in ("cam0.json", "cam1.json", "extrinsics.json"):
            with open(os.path.join(out, name), "rb") as f:
                files[name] = f.read()
        if first is None:
            first = files
        for name, blob in files.items():
            if blob != first[name]:
                raise RuntimeError(f"{tag} {name} differs from run 0's: warm-up changed a result")
        fx = [abs(model_from_json(os.path.join(out, f"cam{c}.json")).params[0] - gt.params[0])
              / gt.params[0] for c in range(2)]
        with open(os.path.join(out, "report.txt")) as f:
            medians = [float(v) for v in
                       re.findall(r"median  reprojection error: ([0-9.]+) px", f.read())]
        print(f"{tag} focal err {[f'{e:.4%}' for e in fx]}, medians {medians} px; cam0.json, "
              f"cam1.json, extrinsics.json equal run 0's byte for byte")
        if not (max(fx) < 0.01 and len(medians) == 2 and max(medians) < 0.3):
            raise RuntimeError(f"{tag} focal {fx} or medians {medians} off")
        runs.append(dict(prewarm=prewarm, wall_s=wall, detect_s=float(detect.group(1)),
                         prewarm_s=float(warm.group(1)) if warm else None,
                         launches=total - by_warmup, launches_prewarm=by_warmup,
                         stages=stages))
    on = [r["wall_s"] for r in runs if r["prewarm"] == "1"]
    off = [r["wall_s"] for r in runs if r["prewarm"] == "0"]
    print(f"[fresh] ({card}) process wall, CCRS_PREWARM=1: {', '.join(f'{t:.3f}' for t in on)} s; "
          f"CCRS_PREWARM=0: {', '.join(f'{t:.3f}' for t in off)} s (in turns; no gate on time)")
    return runs


def single_problem(board, batch, model, rtvecs, device):
    """The 512 phase's final EUCM problem as ``ba_solve`` arguments on
    ``device``: the card's poses, intrinsics 1% off the card's result."""
    import torch

    from ccrs_tpu_torch.calib.single import build_bounds

    F = batch.p2d.shape[0]
    poses, fv = np.zeros((F, 6)), np.zeros(F)
    for f, rt in rtvecs.items():
        poses[f], fv[f] = np.concatenate([rt.rvec, rt.tvec]), 1.0
    lo, hi = build_bounds(model, False)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64, device=device)

    return (t(model.params * 1.01), t(poses), t(board.p3d), t(batch.p2d), t(batch.mask),
            t(lo), t(hi), t(np.ones(len(lo))), t(fv))


def solved_model(model, res, frames):
    """(model, rtvecs on ``frames``) from a BAResult."""
    from ccrs_tpu_torch.types import RvecTvec

    m = model.copy()
    m.set_params(res.theta.cpu().numpy())
    poses = res.poses.cpu().numpy()
    return m, {f: RvecTvec(poses[f, :3], poses[f, 3:]) for f in frames}


def run_rig_phase(card, run512, board):
    """bench_multicam.py's joint BA at full size through the float64 and
    the mixed-precision solver and through the sharded mixed solver, then
    the 512 phase's final problem through ``ba_solve`` and
    ``ba_solve_mixed``.  Returns the numbers it printed."""
    import torch

    from ccrs_tpu_torch.models.projections import project_fn
    from ccrs_tpu_torch.parallel import mesh as pmesh
    from ccrs_tpu_torch.solve.lm import (
        ba_solve,
        ba_solve_mixed,
        ba_solve_multi,
        ba_solve_multi_mixed,
    )
    from ccrs_tpu_torch.testdata import rig_errors, rig_problem

    proj = project_fn("eucm")
    tag = f"[rig {RIG['n_cams']}x{RIG['n_frames']}] ({card})"
    problem, t_gen = sync_time(torch, lambda: rig_problem(seed=0, device="cuda", **RIG))
    args = problem["args"]
    M = args[0].numel() + args[1].numel()

    def solve(name, fn, **kw):
        torch.cuda.reset_peak_memory_stats()
        res, sec = sync_time(torch, lambda: fn(proj, *args, **kw))
        err = rig_errors(problem, res)
        rec = dict(solver=name, seconds=sec, iters=res.n_iters, polish_iters=res.n_polish,
                   peak_mib=torch.cuda.max_memory_allocated() / 2**20, cost=float(res.cost),
                   **err)
        print(f"{tag} {name}: {sec:.3f} s, {res.n_iters} iterations ({res.n_iters - res.n_polish} "
              f"+ {res.n_polish} polish), peak device memory {rec['peak_mib']:.0f} MiB; focal "
              f"err {err['focal_rel_err']:.3e}, extrinsic err {err['ext_err']:.3e}, rms "
              f"{err['rms_px']:.9f} px")
        # bench_multicam.py:182-184
        if not (err["focal_rel_err"] < 3e-3 and err["ext_err"] < 3e-3
                and 0.07 < err["rms_px"] < 0.13):
            raise RuntimeError(f"{tag} {name} missed the rig's gates: {err}")
        return res, rec

    print(f"{tag} generated on the card in {t_gen:.3f} s: {int(args[5].sum()) * 2} residuals, "
          f"reduced system {M} x {M}")
    solves = []
    results = {}
    # one solve each: the bench phase times the mixed route alone in a
    # fresh process (bench_multicam_torch.py)
    for name, fn in (("float64", ba_solve_multi), ("mixed", ba_solve_multi_mixed)):
        results[name], rec = solve(name, fn)
        solves.append(rec)
    mesh = pmesh.make_mesh()
    if len(mesh) == 1:
        mesh = [mesh[0], mesh[0]]
    sharded, rec = solve(f"mixed, {len(mesh)} shards", pmesh.multi_ba_sharded_mixed, mesh=mesh)
    solves.append(rec)
    by = {r["solver"]: r for r in solves}
    d_rms = abs(by["mixed"]["rms_px"] - by["float64"]["rms_px"])
    rel = float(((sharded.theta - results["mixed"].theta).abs()
                 / results["mixed"].theta.abs()).max())
    print(f"{tag} |rms_mixed - rms_float64| = {d_rms:.3e} px; sharded mixed against mixed: theta "
          f"max rel diff {rel:.3e}")
    if not (d_rms < 1e-6):
        raise RuntimeError(f"{tag} the mixed solve left the float64 optimum by {d_rms:.3e} px")
    if not (rel < 1e-8):
        raise RuntimeError(f"{tag} the sharded mixed solve left the mixed one by {rel:.3e}")

    # the 512 phase's final single-camera problem
    batch, model, rtvecs = run512["batch"], run512["model"], run512["rtvecs"]
    sargs = single_problem(board, batch, model, rtvecs, "cuda")
    tag1 = f"[rig, 512 problem {batch.p2d.shape[0]} frames] ({card})"
    single = []
    for name, fn, kw in (
        ("ba_solve float64", ba_solve, {}),
        ("ba_solve_mixed, float32 polish J", ba_solve_mixed, {}),
        ("ba_solve_mixed, float64 polish J", ba_solve_mixed, dict(polish_jac_f32=False)),
        ("ba_solve_mixed, float32 polish J", ba_solve_mixed, {}),
        ("ba_solve float64", ba_solve, {}),
    ):
        res, sec = sync_time(torch, lambda: fn(proj, *sargs, **kw))
        rms = rms_of(board, batch, *solved_model(model, res, rtvecs))
        single.append(dict(solver=name, seconds=sec, iters=res.n_iters,
                           polish_iters=res.n_polish, rms_px=rms))
        print(f"{tag1} {name}: {sec:.3f} s, {res.n_iters} iterations ({res.n_polish} polish), "
              f"rms {rms:.9f} px")
    spread = max(r["rms_px"] for r in single) - min(r["rms_px"] for r in single)
    print(f"{tag1} rms spread over the three solvers {spread:.3e} px")
    if not (spread < 1e-6):
        raise RuntimeError(f"{tag1} the solvers' optima differ by {spread:.3e} px")
    return dict(problem=dict(RIG, residuals=solves[0]["residuals"], reduced_dim=M),
                solves=solves, rms_mixed_minus_f64=d_rms, sharded_theta_rel=rel,
                single_512=single, single_512_rms_spread=spread)


@contextlib.contextmanager
def observe_shard_launches(det, counts):
    """Count the threshold launches of each shard of ``det``'s sharded
    cold pipeline into ``counts`` (one entry per shard)."""
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.parallel.mesh import FrameShards

    real = det._detect_batch_cold
    parts = []

    def wrapper(dev_all, *args, **kwargs):
        if isinstance(dev_all, FrameShards):
            parts[:] = dev_all.parts
            return real(dev_all, *args, **kwargs)
        before = threshold_front_cuda.launches
        out = real(dev_all, *args, **kwargs)
        for i, p in enumerate(parts):
            if p is dev_all:
                counts[i] += threshold_front_cuda.launches - before
        return out

    det._detect_batch_cold = wrapper
    try:
        yield counts
    finally:
        del det._detect_batch_cold


def run_mesh_phase(card, frames512, run512, board, joint):
    """The multi-device layer on the mesh of every visible card (two shards
    of cuda:0 when only one is visible): the 512 phase's final problem
    through ``make_ba_solver`` against ``ba_solve``, the cli phase's joint
    problem through the joint BA's sharded route (``multi_ba_sharded``)
    against its single-device route and a CPU float64 re-solve, and the
    first N_MESH_DETECT frames of the 512 sequence through
    ``TagDetector(shard=True)``, tracked and cold, against the unsharded
    detector.  Returns the threshold launches of the sharded detections."""
    import torch

    from ccrs_tpu_torch.calib import multi
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.models.projections import project_fn
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.parallel import mesh as pmesh
    from ccrs_tpu_torch.solve.lm import ba_solve

    mesh = pmesh.make_mesh()
    if len(mesh) == 1:
        mesh = [mesh[0], mesh[0]]
    n_cards = len({str(d) for d in mesh})
    tag = f"[mesh {len(mesh)} shards on {n_cards} card(s)] ({card})"
    print(f"{tag} mesh {[str(d) for d in mesh]}, {n_cards} distinct card(s)")

    # single camera: the sharded LM against ba_solve on the card
    batch, model, rtvecs = run512["batch"], run512["model"], run512["rtvecs"]
    args = single_problem(board, batch, model, rtvecs, "cuda")
    proj = project_fn("eucm")
    want, t_one = sync_time(torch, lambda: ba_solve(proj, *args))
    (theta0, poses0, p3d, p2d, w, lo, hi, free, fv) = args
    (poses_p, p2d_p, w_p, fv_p), F = pmesh.pad_frames([poses0, p2d, w, fv], len(mesh))
    got, t_sh = sync_time(torch, lambda: pmesh.make_ba_solver(proj, mesh)(
        theta0, poses_p, p3d, p2d_p, w_p, lo, hi, free, fv_p))
    got = got._replace(poses=got.poses[:F])
    rel = float(((got.theta - want.theta).abs() / want.theta.abs()).max())
    rms_sh = rms_of(board, batch, *solved_model(model, got, rtvecs))
    rms_one = rms_of(board, batch, *solved_model(model, want, rtvecs))
    print(
        f"{tag} single camera, {F} frames: sharded {t_sh:.3f} s ({got.n_iters} iterations), "
        f"unsharded ba_solve {t_one:.3f} s ({want.n_iters}); theta max rel diff {rel:.3e}, "
        f"|rms_sharded - rms| = {abs(rms_sh - rms_one):.3e} px (rms {rms_one:.6f} px)"
    )
    if not (rel < 1e-9 and abs(rms_sh - rms_one) < 1e-6):
        raise RuntimeError(f"{tag} the sharded single-camera solve left ba_solve's optimum")

    # the joint BA: its sharded route against its single-device route
    routed = []
    real = multi.multi_ba_sharded
    multi.multi_ba_sharded = lambda *a, **k: routed.append(len(k["mesh"])) or real(*a, **k)
    try:
        with pmesh.default_mesh(mesh):
            sh, t_jsh = sync_time(torch, lambda: multi.calib_all_camera_with_extrinsics(
                *joint["args"], **joint["kwargs"]))
        with pmesh.default_mesh(mesh[:1]):
            one, t_jone = sync_time(torch, lambda: multi.calib_all_camera_with_extrinsics(
                *joint["args"], **joint["kwargs"]))
    finally:
        multi.multi_ba_sharded = real
    if routed != [len(mesh)] or sh is None or one is None:
        raise RuntimeError(f"{tag} the joint BA did not take its sharded route once: {routed}")
    board_j, batches = joint["args"][0], joint["args"][4]
    p_rel = max(float(np.max(np.abs(a.params - b.params) / np.abs(b.params)))
                for a, b in zip(sh[0], one[0]))
    e_abs = max(float(np.max(np.abs(np.concatenate([a.rvec - b.rvec, a.tvec - b.tvec]))))
                for a, b in zip(sh[1], one[1]))
    rms_sh = joint_rms(board_j, batches, *sh)
    rms_one = joint_rms(board_j, batches, *one)
    d_rms = max(abs(a - b) for a, b in zip(rms_sh, rms_one))
    print(
        f"{tag} joint BA, {len(batches)} cameras x {batches[0].p2d.shape[0]} frames: sharded "
        f"route {t_jsh:.3f} s, single-device route {t_jone:.3f} s; theta max rel diff "
        f"{p_rel:.3e}, extrinsic max diff {e_abs:.3e}, per-camera rms diff {d_rms:.3e} px"
    )
    if not (p_rel < 1e-8 and e_abs < 1e-8 and d_rms < 1e-6):
        raise RuntimeError(f"{tag} the sharded joint BA left ba_solve_multi's optimum")
    cpu_joint_gate(joint, sh, f"{tag} sharded joint BA:")

    # detection: sharded equals unsharded bit for bit, tracked and cold
    frames = frames512[:N_MESH_DETECT].contiguous()
    launches = 0
    for track in (True, False):
        name = "tracked" if track else "cold"
        base_det = TagDetector("t36h11", track=track, shard=False, device="cuda")
        base, t_base = sync_time(torch, lambda: base_det.detect_batch(None, board, dev_images=frames))
        det = TagDetector("t36h11", track=track, shard=True, device="cuda")
        per_shard = [0] * len(mesh)
        with pmesh.default_mesh(mesh), observe_shard_launches(det, per_shard):
            threshold_front_cuda.launches = 0
            got, t_det = sync_time(torch, lambda: det.detect_batch(None, board, dev_images=frames))
            n = threshold_front_cuda.launches
        launches += n
        print(
            f"{tag} {name} detection of {len(frames)} frames: sharded {t_det:.3f} s, "
            f"unsharded {t_base:.3f} s; threshold kernel launches {n}, per shard {per_shard}"
        )
        for f, (a, b) in enumerate(zip(got, base)):
            if sorted(a) != sorted(b) or any(not np.array_equal(a[t], b[t]) for t in a):
                raise RuntimeError(f"{tag} {name}: frame {f} differs from the unsharded detection")
        if track and det.stats != base_det.stats:
            raise RuntimeError(f"{tag} tracked stats differ: {det.stats} vs {base_det.stats}")
        if n <= 0 or min(per_shard) <= 0 or sum(per_shard) != n:
            raise RuntimeError(f"{tag} {name}: a shard never launched the threshold kernel")
    print(f"{tag} sharded detection == unsharded bit for bit, tracked and cold")
    return launches


def run_undistort_phase(card, frame):
    """Build the undistortion map of EuRoC's cam0 and remap one cli frame
    of 752x480 to 1024x1024, on the card and on the CPU; gates: maps within
    1e-3 px, pixels within 1 gray level."""
    import torch

    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.models.undistort import (
        estimate_new_camera_matrix_for_undistort,
        init_undistort_map,
        remap,
    )

    tag = f"[undistort 752x480 -> 1024x1024] ({card})"
    model = GenericModel("eucm", EUROC_CAM0, 752, 480)
    out = {}
    for dev in ("cuda", "cpu"):
        K = estimate_new_camera_matrix_for_undistort(model, 1.0, (1024, 1024), device=dev)
        (xmap, ymap), t_map = sync_time(
            torch, lambda: init_undistort_map(model, K, (1024, 1024), device=dev))
        img, t_remap = sync_time(torch, lambda: remap(frame, xmap, ymap))
        if dev == "cuda":  # warm: CUDA events over repeated calls
            ms_map = time_ms(torch, lambda: init_undistort_map(model, K, (1024, 1024), device=dev))
            frame_dev = torch.as_tensor(frame, device=dev)
            ms_remap = time_ms(torch, lambda: remap(frame_dev, xmap, ymap))
            print(f"{tag} card: map {t_map:.4f} s, remap {t_remap:.4f} s first call; warm map "
                  f"{ms_map:.4f} ms, remap {ms_remap:.4f} ms (CUDA events)")
        else:
            print(f"{tag} CPU: map {t_map:.4f} s, remap {t_remap:.4f} s")
        out[dev] = (K, xmap.cpu(), ymap.cpu(), img.cpu())
    (K1, x1, y1, i1), (K2, x2, y2, i2) = out["cuda"], out["cpu"]
    d_map = float(max((x1 - x2).abs().max(), (y1 - y2).abs().max()))
    d_pix = int((i1.int() - i2.int()).abs().max())
    print(f"{tag} K card vs CPU max rel diff {float(np.max(np.abs(K1 - K2)) / K2[0, 0]):.3e}; "
          f"maps max diff {d_map:.3e} px; remapped pixels max diff {d_pix} gray level(s), "
          f"{int((i1 != i2).sum())} of {i1.numel()} differ")
    if not (d_map < 1e-3 and d_pix <= 1 and i1.shape == (1024, 1024)):
        raise RuntimeError(f"{tag} card and CPU undistortion differ")


def run_colour_phase(card, gray_frames):
    """Tinted 8-bit RGB PNGs against the same frames as gray PNGs (the
    loader's integer luma applied on the host), both through ``load_euroc``
    on the card with the default (tracked) detector: equal detections, and
    every threshold launch on the uint8 path."""
    from ccrs_tpu_torch import dataloader as dl
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.pngio import write_png

    n, h, w = gray_frames.shape
    tag = f"[colour {n}x{h}x{w}] ({card})"
    wobble = (np.add.outer(np.arange(h), np.arange(w)) % 3)[..., None] * np.array([1, 0, 2])
    board = create_default_6x6_board()
    batches, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="ccrs_chip_smoke_colour_") as tmp:
        for kind in ("rgb", "gray"):
            d = os.path.join(tmp, kind, "mav0", "cam0", "data")
            os.makedirs(d)
            for f in range(n):
                rgb = np.clip(gray_frames[f][..., None] * np.array([0.93, 1.0, 0.62]) + wobble,
                              0, 255).astype(np.uint8)
                img = rgb if kind == "rgb" else dl._gray_like_cv2(rgb)
                write_png(os.path.join(d, f"{10_000_000_000 + f * 100_000_000}.png"), img)
        if dl._imread(os.path.join(d, "10000000000.png")).shape != (h, w):
            raise RuntimeError(f"{tag} the gray dataset did not decode to one plane")
        for kind in ("rgb", "gray"):
            threshold_front_cuda.launches = threshold_front_cuda.launches_u8 = 0
            det = TagDetector("t36h11", device="cuda")
            t0 = time.perf_counter()
            batches[kind] = dl.load_euroc(os.path.join(tmp, kind), det, board)[0]
            launches[kind] = (threshold_front_cuda.launches, threshold_front_cuda.launches_u8)
            print(f"{tag} {kind} PNGs: load_euroc {time.perf_counter() - t0:.3f} s, "
                  f"{int(batches[kind].mask.sum())} corners on "
                  f"{int(batches[kind].frame_ok().sum())} usable frames, threshold launches "
                  f"{launches[kind][0]} ({launches[kind][1]} on the uint8 path)")
    a, b = batches["rgb"], batches["gray"]
    same = (np.array_equal(a.time_ns, b.time_ns) and np.array_equal(a.mask, b.mask)
            and np.array_equal(a.p2d[a.mask], b.p2d[b.mask]))
    if not same or a.n_frames != n or not a.mask.any():
        raise RuntimeError(f"{tag} colour PNGs and their host gray detect differently")
    for kind, (total, u8) in launches.items():
        if total <= 0 or u8 != total:
            raise RuntimeError(f"{tag} {kind}: {u8} of {total} threshold launches were uint8")
    print(f"{tag} detections from the RGB PNGs == from their integer-luma gray, bit for bit")
    return launches["rgb"][0] + launches["gray"][0]


def unmatched_quads(native, device, tol):
    """How many native quads have no device quad whose corners (as sets,
    rounded to pixels, each used once) lie within ``tol``."""
    used, missing = set(), 0
    for a in native:
        ca = np.sort(a.round(0), axis=0)
        for j, b in enumerate(device):
            if j not in used and np.abs(ca - np.sort(b.round(0), axis=0)).max() <= tol:
                used.add(j)
                break
        else:
            missing += 1
    return missing


def run_ccl_phase(card, frames, scale, label):
    """Device quad extraction on the threshold kernel's bitmaps of
    ``frames`` (a chunk on the card): card against CPU, against the native
    quadproc, and its warm time beside the host route's."""
    import torch

    from ccrs_tpu_torch.detect.ccl import extract_quads_device, label_components
    from ccrs_tpu_torch.detect.quads import extract_quads_batch
    from ccrs_tpu_torch.detect.threshold import threshold_front
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda

    B, H, W = frames.shape
    sH, sW = H // scale, W // scale
    tag = f"[ccl {label}, bitmaps {B}x{sH}x{sW}] ({card})"
    launched = threshold_front_cuda.launches
    packed = threshold_front(frames, scale)
    if threshold_front_cuda.launches != launched + 1:
        raise RuntimeError(f"{tag} the bitmaps did not come from the threshold kernel")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    binary = ((packed[..., None] >> shifts) & 1).reshape(B, packed.shape[1], -1)
    binary = binary[:, :sH, :sW].contiguous()

    # the card against the CPU, bit for bit
    n_cpu = min(N_CCL_CPU, B)
    torch.cuda.reset_peak_memory_stats()
    labels = label_components(binary)
    quads, valid = extract_quads_device(binary, max_quads=CCL_MAX_QUADS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not (labels.is_cuda and quads.is_cuda and valid.is_cuda):
        raise RuntimeError(f"{tag} the device route did not run on the card")
    host = binary[:n_cpu].cpu()
    t0 = time.perf_counter()
    labels_cpu = label_components(host, device="cpu")
    quads_cpu, valid_cpu = extract_quads_device(host, max_quads=CCL_MAX_QUADS, device="cpu")
    t_cpu = time.perf_counter() - t0
    d_quads = float((quads[:n_cpu].cpu() - quads_cpu).abs().max())
    ok = (torch.equal(labels[:n_cpu].cpu(), labels_cpu)
          and torch.equal(valid[:n_cpu].cpu(), valid_cpu) and d_quads == 0.0)
    print(f"{tag} card vs CPU on {n_cpu} frames: labels equal "
          f"{torch.equal(labels[:n_cpu].cpu(), labels_cpu)}, valid equal "
          f"{torch.equal(valid[:n_cpu].cpu(), valid_cpu)}, quads max diff {d_quads:.3e} px "
          f"(CPU {t_cpu:.1f} s)")
    if not ok:
        raise RuntimeError(f"{tag} device quad extraction differs between card and CPU")
    n_white = int((labels == sH * sW).sum())
    if n_white != int((binary != 0).sum()):
        raise RuntimeError(f"{tag} white pixels lost their label")

    # against the native quadproc on the same bitmaps
    qn, cn = extract_quads_batch(binary.cpu().numpy(), max_quads=CCL_MAX_QUADS)
    q, v = quads.cpu().numpy(), valid.cpu().numpy()
    n_native, n_device, missing = int(cn.sum()), int(v.sum()), 0
    for b in range(B):
        missing += unmatched_quads(qn[b, : cn[b]], q[b][v[b]], 1.5)
    share = missing / max(n_native, 1)
    print(f"{tag} native quadproc {n_native} quads, device {n_device}; {missing} native quads "
          f"({share:.1%}) have no device quad within 1.5 px (gate {CCL_MAX_UNMATCHED:.0%})")
    if n_native == 0 or n_device < n_native - missing or share > CCL_MAX_UNMATCHED:
        raise RuntimeError(f"{tag} device quads do not cover the native quads")

    # warm time of the chunk: device route against the host route
    ms_labels = time_ms(torch, lambda: label_components(binary), reps=3)
    ms_quads = time_ms(
        torch, lambda: extract_quads_device(binary, max_quads=CCL_MAX_QUADS), reps=3)
    host_s = []
    for _ in range(3):
        _, sec = sync_time(torch, lambda: extract_quads_batch(
            np.unpackbits(packed.cpu().numpy(), axis=-1)[:, :sH, :sW],
            max_quads=CCL_MAX_QUADS))
        host_s.append(sec)
    host_ms = min(host_s) * 1e3
    print(f"{tag} warm per chunk of {B}: label_components {ms_labels:.3f} ms, "
          f"extract_quads_device {ms_quads:.3f} ms (CUDA events, 3 calls); host route "
          f"(bitmap download + unpack + quadproc) {host_ms:.3f} ms (best of 3); peak device "
          f"memory {peak / 2**20:.0f} MiB")
    return dict(shape=f"{label}, bitmaps {B}x{sH}x{sW}", labels_ms=ms_labels,
                quads_ms=ms_quads, host_ms=host_ms, peak_mib=peak / 2**20,
                native=n_native, device=n_device, unmatched=missing)


def run_tools_phase(card):
    """The board generator as a subprocess and one host-rendered frame
    detected on the card."""
    import torch

    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import TagDetector, get_family
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.pngio import read_png
    from ccrs_tpu_torch.solve import se3
    from ccrs_tpu_torch.testdata import front_view_base, render_board_image

    tag = f"[tools] ({card})"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="ccrs_chip_smoke_board_") as tmp:
        png = os.path.join(tmp, "board.png")
        out = subprocess.run(
            [sys.executable, "-m", "ccrs_tpu_torch.make_board", png, "--dpi", "72"],
            capture_output=True, text=True, env=env, cwd=tmp, timeout=300,
        )
        if out.returncode != 0:
            raise RuntimeError(f"{tag} make_board exited {out.returncode}: {out.stderr[-2000:]}")
        for line in out.stdout.splitlines():
            print(f"{tag} make_board: {line}")
        img = read_png(png)
    m = re.search(r": (\d+)x(\d+) px", out.stdout)
    if not m or img.shape != (int(m.group(2)), int(m.group(1))) or img.dtype != np.uint8 \
            or set(np.unique(img)) != {0, 255}:
        raise RuntimeError(f"{tag} the board PNG does not hold what make_board printed")

    board = create_default_6x6_board()
    model = GenericModel("eucm", GT_512, 512, 512)
    zero = torch.zeros(3, dtype=torch.float64)
    rv, _ = se3.compose(torch.tensor([0.15, -0.1, 0.05], dtype=torch.float64), zero,
                        torch.as_tensor(front_view_base()), zero)
    rvec = rv.numpy()
    tvec = np.array([0.0, 0.0, 0.6]) - se3.exp_so3(rv).numpy() @ board.p3d.mean(0)
    t0 = time.perf_counter()
    frame = render_board_image(model, board, get_family("t36h11"), rvec, tvec, noise=1.0, seed=0)
    t_render = time.perf_counter() - t0
    tags = TagDetector("t36h11", device="cuda").detect(frame)
    print(f"{tag} render_board_image {frame.shape} {frame.dtype} on the host in "
          f"{t_render:.3f} s; the card's detector finds {len(tags)} tags")
    if frame.shape != (512, 512) or frame.dtype != np.uint8 or len(tags) < 30:
        raise RuntimeError(f"{tag} the host-rendered frame gave {len(tags)} tags (< 30)")


def run_bench_phase(card):
    """The port's two timing programs, each as a user starts it: a fresh
    process at full size (``bench_torch.py``: 534 frames at 512x512 and 128
    at 1024x1024; ``bench_multicam_torch.py``: 8 cameras x 1000 frames).
    Each must exit 0 and end with one JSON line, which is returned;
    ``bench_torch.py`` must report threshold kernel launches.  Returns
    ({program: its JSON line}, bench_torch.py's launches)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for knob in [k for k in env if k.startswith("BENCH_")] + ["CCRS_TRACK", "CCRS_PREWARM"]:
        env.pop(knob, None)
    lines, launches = {}, None
    for program, limit in BENCH_PROGRAMS:
        tag = f"[bench {program}] ({card})"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(root, program)],
                              capture_output=True, text=True, env=env, cwd=root,
                              timeout=limit)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} exited {proc.returncode}: {proc.stderr[-3000:]}")
        # its progress lines: runs, stages, gates (not the CLI's own output)
        for line in proc.stderr.splitlines():
            if line.startswith(("[", "  stage", "  warmup stage", "  detector stats",
                                "threshold kernel", "iters=", "sharding")):
                print(f"{tag} {line}")
        out = proc.stdout.strip().splitlines()
        lines[program] = json.loads(out[-1])
        print(f"{tag} wall {wall:.3f} s from process start to exit; last line: {out[-1]}")
        m = re.search(r"threshold kernel launches over the run: (\d+)", proc.stderr)
        if program == "bench_torch.py":
            if not m or int(m.group(1)) <= 0:
                raise RuntimeError(f"{tag} reported no threshold kernel launches")
            launches = int(m.group(1))
    return lines, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ccrs_tpu_torch.utils import profiling

    profiling.enable()
    card = card_label()
    print(card)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}"
    )
    import concurrent.futures as cf

    from ccrs_tpu_torch import pngio
    from ccrs_tpu_torch.detect import quads
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
    ptxas = ptxas_summary()
    for line in ptxas:
        print(f"ptxas -v: {line}")
    if not ptxas:
        print("ptxas -v: no report (the kernel library was not rebuilt in this run)")

    frames512, scale, launches512, run512 = run_phase(512, N_512, card)
    k512 = check_kernel(frames512, scale, card, f"{N_512}x512x512")
    ccl = [run_ccl_phase(card, frames512[: N_CCL[512]].contiguous(), scale, "512 phase")]
    frames, scale, launches1024, _ = run_phase(1024, N_1024, card)
    k1024 = check_kernel(frames, scale, card, f"{N_1024}x1024x1024")
    ccl.append(run_ccl_phase(card, frames[: N_CCL[1024]].contiguous(), scale, "1024 phase"))
    del frames
    cli_frames, launches_cli, joint, fresh = run_cli_phase(card)
    if launches_cli <= 0:
        raise RuntimeError("the CLI run never launched the threshold kernel")
    launches_fresh = sum(r["launches"] for r in fresh)
    launches_prewarm = sum(r["launches_prewarm"] for r in fresh)
    if launches_fresh <= 0 or launches_prewarm <= 0:
        raise RuntimeError("the fresh-process CLI runs never launched the threshold kernel")
    from ccrs_tpu_torch.board import create_default_6x6_board

    rig = run_rig_phase(card, run512, create_default_6x6_board())
    launches_mesh = run_mesh_phase(card, frames512, run512, create_default_6x6_board(), joint)
    del frames512
    run_undistort_phase(card, cli_frames[0][0])
    launches_colour = run_colour_phase(card, cli_frames[0][:N_COLOUR])
    run_tools_phase(card)
    bench, launches_bench = run_bench_phase(card)
    # every decoded frame of both cameras, as one sequence of 2 x 640 frames
    kcli = check_kernel(torch.as_tensor(np.concatenate(cli_frames)).cuda(), 1, card,
                        f"2 cameras x {N_CLI}x480x752")
    torch.cuda.synchronize()
    shapes = [k512, k1024, kcli]

    print(json.dumps({"ccl": ccl, "card": card}))
    print(json.dumps({"fresh": fresh, "rig": rig, "card": card}))
    print(json.dumps({"bench": bench, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "threshold_front",
        "route": "cuda",
        "source": "ccrs_tpu_torch/csrc/threshold.cu",
        "replaces": "ccrs_tpu/ops/threshold_pallas.py:35",
        "launches": (launches512 + launches1024 + launches_cli + launches_mesh
                     + launches_colour + launches_fresh + launches_bench),
        "launches_512": launches512,
        "launches_1024": launches1024,
        "launches_cli": launches_cli,
        "launches_mesh": launches_mesh,
        "launches_colour": launches_colour,
        # the subprocess CLI runs' own launches, and their warm-up threads'
        # (each child prints its library's count and, of that, what the
        # wrapper counted on the warm-up thread)
        "launches_fresh": launches_fresh,
        "launches_prewarm": launches_prewarm,
        # bench_torch.py's run in its own process (the library's count)
        "launches_bench": launches_bench,
        "max_abs_err": max(k["max_abs_err"] for k in shapes),
        "ms": k512["ms"],
        "plain_ms": k512["plain_ms"],
        "bound_ms": k512["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
        "device_ms": k512["device_ms"],
        "bound_us": k512["bound_us"],
        "bound_share": k512["bound_share"],
        "bytes": k512["bytes"],
        "shape": k512["shape"],
        "shapes": shapes,  # 512, 1024 and both cli cameras, each with the keys above
        "ptxas": ptxas,
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
