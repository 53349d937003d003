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
  the CLI (``<ds> --model eucm --cam-num 2 --platform cuda --no-rerun
  --seed 1``) as a SUBPROCESS, seven times (``FRESH_RUNS``): with
  ``CCRS_PREWARM=1``, then with ``0`` eager, solvers eager, graphs,
  graphs, solvers eager, eager (each run calls ``cli.main`` from a
  ``python -c`` wrapper, ``FRESH_CHILD``: eager inside ``graphs.eager()``,
  solvers eager inside ``solvers_eager()``, which leaves detection its
  graphs): each run's wall time from process start to exit, its
  "detecting feature took" line and stage timers, and the graphs it holds
  at its end with their pools; gates: exit code 0 on the card, ``cam0.json``, ``cam1.json`` and
  ``extrinsics.json`` byte for byte equal across the runs (warm-up and
  graphs change timing, never results), fx within 1%, medians below 0.3
  px, no warm-up or speculation error, the threshold kernel launched (by
  the run, and by the warm-up where it is on).  No gate on time;
- phase rig: ``bench_multicam.py``'s joint BA at its full size (8 cameras
  x 1000 frames, 36 tags x 4 corners, 0.75 visibility, 0.1 px noise),
  generated on the card (``testdata.rig_problem``), through
  ``ba_solve_multi`` (float64, its loop eager) and ``ba_solve_multi_mixed``, once each, and
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
- phase pipeline: the cold detector's three-phase chunk pipeline (the
  cold composition's detector, ``CCRS_TRACK=0``) on the 534 frames of the
  512 phase and on both cameras of the cli phase (2 x 640 frames at
  752x480), against the same frames detected chunk by chunk, one chunk
  per call with the same chunk boundaries: detections equal bit for bit,
  the threshold kernel launched; the best of 3 warm walls of each in
  turns, the five ``detect/*`` stage totals of the best runs, the device's
  busy share (torch.profiler), the peak device memory of each, and the
  first synchronizing CUDA call that one pipelined 64-frame chunk still
  makes (``torch.cuda.set_sync_debug_mode("error")``), by site and stage,
  or none.  The peak memory above the frames of a pipelined run on the
  first 128 and on all 534 frames of the 512 sequence: it must not grow
  by more than ``FLAT_MIB`` (phase 2 runs one chunk behind phase 1, so at
  most two chunks' KLT maps are alive).  With graphs (the card's default
  since the graphs phase came) the chunks follow the JAX accelerator plan
  and the decodes are replayed graphs.  Then the 512 phase's tracked main
  path eagerly (``graphs.eager()``) once with the natural chunk plan and
  once with the JAX accelerator plan (``CCRS_FORCE_CHUNK_PLAN=1``: 8-frame
  tail pieces), with both walls;
- phase sampling, run eagerly (``graphs.eager()``), as it was measured
  before the graphs came: the two branches of ``detect/sample.py`` (banded
  and hat-weight products, or tap loops and gathers; the card takes the
  gather branch unless a caller forces one).  (a) The four functions
  (``unsharp_mm``, ``build_klt_maps``, ``refine_corners_mm``,
  ``sample_bilinear_mm``) on the inputs the detector gives them in one
  64-frame chunk of the 512 frames (its quadproc quads) and in the first
  wave of the tracked 512 path, through both branches on the card: held
  at ``tests/test_sample.py``'s tolerances (refined corners where the
  decode found a tag), and the card's matmul branch against the CPU's on 8
  frames or rows (float32 rounding); the synthetic saddle within 0.05 px
  in both; the first 64 frames detected in one call and in calls of 32
  and of 8 under each branch (the gather branch's corners must not depend on the
  batch; the matmul branch's difference is printed).  (b) The cold
  detector and the tracked main path under each
  branch (``sample.matmul_branch``): ids equal, 99.9% of the corners
  within 5e-3 px and all within 5e-2 px,
  and for the tracked 512 and 1024 main paths the calibration gates of
  the 512 phase (focal < 1%, median < 0.3 px, CPU float64 re-solve within
  1e-6 px).  (c) In turns (matmul, gather, gather, matmul, matmul,
  gather) at 512, 1024 and on the cli frames: the best of 3 warm walls,
  the ``detect/*`` stages, busy share, peak memory above the frames,
  CUDA kernels and device time per cold 64-frame chunk and per wave
  (torch.profiler), and one line naming the card's default branch and
  what this run's rule (keep the gather branch if the matmul branch's
  best 512 wall, tracked or cold, is slower by more than the spread
  between runs) would take;
- phase graphs: the detect path's captured CUDA graphs (``detect/graphs.py``,
  the card's default: the refine + decode and the assist decode of every
  cold chunk, the wave step of every wave) against eager torch
  (``graphs.eager()``) on the cold detector at 534 x 512^2, 128 x 1024^2
  and the cli frames and on the tracked 512 and 1024 main paths: a first
  run from an empty graph cache (captures, replays, capture seconds, pool
  MiB) and a second one, which must capture nothing; then eager and graphs
  in turns (eager, graphs, graphs, eager, eager, graphs): every graphed
  run's detections equal the eager ones bit for bit (ids and corners), best
  of 3 warm walls and the spread, ``detect/*`` stages, peak memory above
  the frames, busy share (torch.profiler), host launch calls
  (``cudaLaunchKernel`` and its variants plus ``cudaGraphLaunch``) and
  device time per 64-frame cold chunk and per wave; a line with the
  default rule's verdict (eager if graphs' best 512 wall, tracked or cold,
  is slower by more than the spread); then the tracked 512 main path with
  graphs on natural chunks (one decode graph per chunk size) against the
  JAX plan, in turns;
- phase solver: calibration's captured graphs (``solve/lm.py``'s device
  loop: a start graph and a graph of ``CHUNK_ITERS`` LM iterations per
  shape, one host read per replay; ``graphs.call`` for the pose init, the
  init attempt's pieces, the conversion's projections) against eager on
  the 512 phase's problems: its final ``ba_solve`` problem, one
  ``try_init_camera`` on its two init frames with fixed draws,
  ``convert_model`` from that UCM to EUCM and to KB4, and ``calib_camera``
  as the speculation calls it (its subsampled frames, float32 pose init)
  and as the final solve calls it (warm and cold); per problem a
  first run from an empty cache (captures, capture seconds, pools) and a
  second that must capture nothing, then eager and graphs in turns: every
  result and ``n_iters`` bit-equal to eager, best of 3 walls and the
  spread, LM iterations, host reads and masked iterations, host launch
  calls, card time per iteration and busy share (torch.profiler).  Then
  the rig's float64 ``ba_solve_multi`` graphed (first and second run)
  against the rig phase's eager solve, bit for bit; the chunk length
  swept over ``SOLVER_KS`` on the 512 problem and the init attempt; and
  the 512 main path, tracked and cold, with solver graphs against solver
  eager (this script's ``solvers_eager``: detection keeps its graphs) in
  turns, results bit-equal.  A line gives the default rule's verdict
  (eager if solver graphs are slower than solvers eager beyond the spread
  on either 512 main path or on the fresh phase's runs with the warm-up
  off);
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
The card-vs-CPU comparisons run the CPU side in the card's sampling
branch, so both compute the same formulation.
The cli runs gate fx within 1% for both cameras, each median of
``report.txt`` below 0.3 px, the extrinsic within 2e-3 of the rig, usable
frames >= 80%, a CPU float64 re-solve of the joint BA from the card's
result at the same RMS within 1e-6 px, and no speculation error.  In
every phase the threshold kernel is held bit for bit against its plain
torch version on every frame (for cli: every decoded frame of both
cameras) and both are timed over the whole sequence in the chunks of the
cold detector's plan on the card (64-frame pieces, then 8-frame tail
pieces, the last one clipped): the kernel by CUDA events around the loop
of wrapper calls,
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
one of the solver phase's,
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
#: MiB the pipelined cold detector's peak memory above the frames may grow
#: by from 128 to 534 frames of 512x512 (one 64-frame chunk's KLT maps are
#: 448 MiB, so a third chunk alive at once fails it)
FLAT_MIB = 256
#: cli cam0 frames the colour phase writes as RGB and as gray PNGs
N_COLOUR = 48
#: the solver phase: the init attempt's RANSAC draws, and the chunk
#: lengths swept
INIT_DRAWS_SEED = 7
SOLVER_KS = (2, 4, 8)
#: the fresh phase's runs, in this order: (CCRS_PREWARM, mode): "graphs"
#: (the card's default), "eager" (everything eager) or "solvers_eager"
#: (calibration eager, detection graphed: what calibration's graphs do alone)
FRESH_RUNS = (("1", "graphs"), ("0", "eager"), ("0", "solvers_eager"), ("0", "graphs"),
              ("0", "graphs"), ("0", "solvers_eager"), ("0", "eager"))
#: a fresh run's process: the CLI (``cli.main``, as ``python -m
#: ccrs_tpu_torch`` runs it) inside the mode's scope (argv: mode, then the
#: CLI's arguments), then the graphs it holds and their pools
FRESH_CHILD = (
    "import contextlib, json, sys\n"
    "from chip_smoke import solvers_eager\n"
    "from ccrs_tpu_torch import cli, graphs\n"
    "scope = {'graphs': contextlib.nullcontext, 'eager': graphs.eager,\n"
    "         'solvers_eager': solvers_eager}[sys.argv[1]]\n"
    "with scope():\n"
    "    cli.main(sys.argv[2:])\n"
    "print('graphs held: ' + json.dumps(graphs.counts()))\n")
#: bench_multicam.py's rig: cameras, frames per camera, visibility of cameras > 0
RIG = dict(n_cams=8, n_frames=1000, vis_frac=0.75)
#: the bench phase's programs (each in a fresh process, at full size) and
#: the seconds each may take
BENCH_PROGRAMS = (("bench_torch.py", 600), ("bench_multicam_torch.py", 300))
#: frames per shape the ccl phase extracts on the card, and of those on the CPU
N_CCL = {512: 64, 1024: 16}
N_CCL_CPU = 8
#: the four functions of detect/sample.py the sampling phase holds
SAMPLING_FUNCS = ("unsharp_mm", "build_klt_maps", "refine_corners_mm", "sample_bilinear_mm")
#: (rtol, atol) of the matmul branch against the gather branch on the card:
#: tests/test_sample.py's (samples and images in gray levels, corners in px)
SAMPLING_BRANCH_TOL = {"unsharp_mm": (0, 1e-2), "build_klt_maps": (1e-4, 2e-2),
                       "refine_corners_mm": (0, 5e-3), "sample_bilinear_mm": (0, 1e-2)}
#: (rtol, atol) of the card's matmul branch against the CPU's: float32
#: sums in another order (the maps sum 49 products of values up to ~1e5)
SAMPLING_CPU_TOL = {"unsharp_mm": (0, 1e-3), "build_klt_maps": (1e-5, 2e-2),
                    "refine_corners_mm": (0, 1e-3), "sample_bilinear_mm": (0, 1e-3)}
#: frames of the chunk and rows of the wave the CPU samples as well
N_SAMPLING_CPU = 4
#: the two branches' corners of the same detected tag: at least this share
#: within BRANCH_CORNER_TOL px (tests/test_sample.py's refine tolerance)
#: and every one within BRANCH_CORNER_MAX px.  An ill-conditioned corner
#: moves by up to a few 1e-2 px under a 1-ulp change of its window sums
#: (ROADMAP, C), and the branches sum in another order
BRANCH_CORNER_TOL = 5e-3
BRANCH_CORNER_SHARE = 0.999
BRANCH_CORNER_MAX = 5e-2
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
    """Run fn, synchronize every visible card, return (result, seconds).  The
    synchronize waits for a capture on another thread to end
    (``graphs.synchronize``): the speculation thread may be capturing its
    solver graphs when detection returns, and CUDA fails a device-wide
    synchronize while any stream captures."""
    from ccrs_tpu_torch import graphs

    cards = list(range(torch.cuda.device_count()))
    graphs.synchronize(cards)
    t0 = time.perf_counter()
    out = fn()
    graphs.synchronize(cards)
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


def cpu_resolve_gate(board, batch, model, rtvecs, tag):
    """A float64 re-solve on the CPU from the card's result lands on the
    same optimum: RMS within 1e-6 px.  Returns the card's RMS."""
    from ccrs_tpu_torch.calib import calib_camera

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
    return rms_card


def card_branch():
    """Whether the card takes the matmul branch of ``detect/sample.py`` by
    default (the port decides by the frames' device alone)."""
    import torch

    from ccrs_tpu_torch.detect import sample

    return sample._use_mm(None, torch.empty(0, device="cuda"))


def branch_name(matmul):
    return "matmul" if matmul else "gather"


def same_detections(got, want, label, what, exact=False, tol=1e-3):
    """Ids exact per frame, corners within ``tol`` px (bit for bit if
    exact)."""
    if len(got) != len(want):
        raise RuntimeError(f"{label} {what}: {len(got)} frames against {len(want)}")
    for f, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            raise RuntimeError(f"{label} {what}: frame {f} ids differ: {set(g) ^ set(w)}")
        for t in g:
            err = float(np.abs(g[t] - w[t]).max())
            if not (err == 0 if exact else err < tol):
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


def profile_run(torch, fn):
    """Run fn under torch.profiler: device busy seconds (the CUDA kernel and
    copy events, every card summed, and per card), wall seconds of the
    profiled run, the names of the CUDA kernels run, the host launch calls
    it made (the CUDA runtime's kernel launches, ``cudaLaunchKernel`` and
    its variants, and ``cudaGraphLaunch``, as CPU-side events) and its
    copy and fill calls (``cudaMemcpy*``, ``cudaMemset*``).  Reads the
    profiler's raw events: building its per-op event objects
    (``prof.events()``) takes tens of microseconds an op, seconds per
    run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(torch, fn)
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    host = [e.name() for e in events if e.device_type() != DeviceType.CUDA]
    graph_launches = sum(n == "cudaGraphLaunch" for n in host)
    kernel_launches = sum("LaunchKernel" in n for n in host)
    by_card = {}
    for e in device:
        by_card[e.device_index()] = by_card.get(e.device_index(), 0) + e.duration_ns() / 1e9
    return dict(busy_s=sum(e.duration_ns() for e in device) / 1e9, wall_s=wall,
                busy_by_card_s=by_card,
                kernels=[e.name() for e in device
                         if not e.name().startswith(("Memcpy", "Memset"))],
                launch_calls=kernel_launches + graph_launches,
                graph_launches=graph_launches,
                copy_calls=sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in host))


def device_busy_share(torch, fn):
    """``profile_run``'s (device busy seconds, wall seconds, CUDA kernel
    names)."""
    r = profile_run(torch, fn)
    return r["busy_s"], r["wall_s"], r["kernels"]


def run_phase(size, n_frames, card):
    import torch

    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
    from ccrs_tpu_torch.detect import TagDetector, get_family, sample
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
    rms_card = cpu_resolve_gate(board, batch, model, rtvecs, tag)

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
    # (the CPU runs the card's sampling branch, so both sides compute the
    # same formulation)
    few = list(range(0, n_frames, max(1, n_frames // 4)))[:4]
    branch = card_branch()
    with sample.matmul_branch(branch):
        cpu_cold = TagDetector("t36h11", track=False, device="cpu").detect_batch(
            None, board, dev_images=frames[few].cpu()
        )
    same_detections([cold[f] for f in few], cpu_cold, tag, "cold card vs CPU")
    n48 = min(48, n_frames)
    trk_card, trk_cpu = TagDetector("t36h11", device="cuda"), TagDetector("t36h11", device="cpu")
    got = trk_card.detect_batch(None, board, dev_images=frames[:n48])
    t1 = time.perf_counter()
    with sample.matmul_branch(branch):
        want = trk_cpu.detect_batch(None, board, dev_images=frames[:n48].cpu())
    same_detections(got, want, tag, "tracked card vs CPU")
    if trk_card.stats != trk_cpu.stats:
        raise RuntimeError(f"{tag} tracked stats differ: card {trk_card.stats} cpu {trk_cpu.stats}")
    print(
        f"{tag} card decode matches the CPU path ({branch_name(branch)} branch on both): "
        f"cold on frames {few}, tracked on frames 0..{n48 - 1} with equal stats "
        f"({time.perf_counter() - t1:.1f} s on the CPU)"
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
        busy, wall, _ = device_busy_share(
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
    return frames, 2 if size >= cold_det.pyramid_min_side else 1, sum(launches), run


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


def chunk_spans(B):
    """(first frame, frames) of each chunk the cold detector runs for a
    B-frame batch on the card (``CCRS_DETECT_CHUNK`` frames each, the last
    one short)."""
    from ccrs_tpu_torch.detect import TagDetector

    return TagDetector("t36h11", device="cuda")._spans(B)


def check_kernel(frames, scale, card, label):
    """Kernel against its plain version on every frame, bit for bit; the
    time of both over the whole sequence in main-path chunks (CUDA events
    around the loop of calls, wrapper included), the kernel's device time
    (CUDA events around back-to-back launches; torch.profiler's beside it),
    and the bytes it must move with the bound they give."""
    import torch

    from ccrs_tpu_torch.detect.threshold import threshold_front_plain
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda

    B, H, W = frames.shape
    tag = f"[{label}] ({card})"
    spans = chunk_spans(B)
    plan = "+".join(str(n) for _, n in spans)
    max_err, out_bytes = 0, 0
    for lo, n in spans:
        part = frames[lo : lo + n].contiguous()
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

    parts = [frames[lo : lo + n].contiguous() for lo, n in spans]
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
        f"chunks of the detector's plan ({plan}): kernel {ms:.4f} ms (CUDA events around the calls), "
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
    return dict(shape=f"{label} {frames.dtype}, scale {scale}, chunks {plan}",
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


def fresh_run(tmp, ds, gt, tag, out, prewarm, mode, env_extra=None):
    """One fresh CLI process (``FRESH_CHILD``) on the cli phase's dataset,
    written to ``out``, and its gates (exit 0, on the card, no warm-up or
    speculation error, threshold launches, focal and medians).  Returns
    (its record, its artifacts' bytes)."""
    from ccrs_tpu_torch.models import model_from_json

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.update(CCRS_PREWARM=prewarm, CCRS_TIMING="1",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""), **(env_extra or {}))
    env.pop("CCRS_TRACK", None)
    argv = [ds, "--model", "eucm", "--cam-num", "2", "--platform", "cuda", "--no-rerun",
            "--seed", "1", "-o", out]
    cmd = [sys.executable, "-c", FRESH_CHILD, mode, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp, timeout=600)
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
    held = re.search(r"^graphs held: (.*)$", proc.stdout, re.M)
    if not (detect and count and held):
        raise RuntimeError(f"{tag} printed no detection time, launch count or graphs held")
    held = json.loads(held.group(1))
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
          f"{total} ({by_warmup} by the warm-up); at its end {held['graphs']} graphs "
          f"held, pools {held['pool_mib']:.1f} MiB ({held['captures']} captures in "
          f"{held['capture_s']:.3f} s)")
    for name in sorted(stages, key=lambda k: -stages[k]):
        print(f"{tag}   {name:26s} {stages[name]:8.3f} s")
    files = {}
    for name in ("cam0.json", "cam1.json", "extrinsics.json"):
        with open(os.path.join(out, name), "rb") as f:
            files[name] = f.read()
    fx = [abs(model_from_json(os.path.join(out, f"cam{c}.json")).params[0] - gt.params[0])
          / gt.params[0] for c in range(2)]
    with open(os.path.join(out, "report.txt")) as f:
        medians = [float(v) for v in
                   re.findall(r"median  reprojection error: ([0-9.]+) px", f.read())]
    if not (max(fx) < 0.01 and len(medians) == 2 and max(medians) < 0.3):
        raise RuntimeError(f"{tag} focal {fx} or medians {medians} off")
    print(f"{tag} focal err {[f'{e:.4%}' for e in fx]}, medians {medians} px")
    return dict(prewarm=prewarm, mode=mode, wall_s=wall, detect_s=float(detect.group(1)),
                prewarm_s=float(warm.group(1)) if warm else None,
                launches=total - by_warmup, launches_prewarm=by_warmup,
                stages=stages, graphs_held=held), files


def run_fresh_phase(tmp, ds, gt, card):
    """The CLI as a user starts it: a new process per run (``cli.main`` in
    a ``python -c`` wrapper, ``FRESH_CHILD``), on the cli phase's dataset:
    the warm-up on, then with it off the card's default (graphs),
    everything eager (``graphs.eager()``) and calibration eager with
    detection graphed (``solvers_eager``) in turns (``FRESH_RUNS``).  Every
    run's artifacts equal byte for byte.  With several cards visible, two
    more runs of the default: every card visible (the joint BA and
    detection shard over them), then ``CUDA_VISIBLE_DEVICES=0``; their
    parameters and extrinsics within 1e-8 of run 0's.  Returns one record
    per run (wall seconds, the lines it printed about itself, its
    threshold launches, the graphs it held at its end and their pools)."""
    import torch

    from ccrs_tpu_torch.io import object_from_json
    from ccrs_tpu_torch.models import model_from_json
    from ccrs_tpu_torch.types import RvecTvec

    runs, first = [], None
    for i, (prewarm, mode) in enumerate(FRESH_RUNS):
        tag = f"[fresh {i}, CCRS_PREWARM={prewarm}, {mode}] ({card})"
        rec, files = fresh_run(tmp, ds, gt, tag, os.path.join(tmp, f"fresh{i}"), prewarm, mode)
        if first is None:
            first = files
        for name, blob in files.items():
            if blob != first[name]:
                raise RuntimeError(f"{tag} {name} differs from run 0's: warm-up changed a result")
        print(f"{tag} cam0.json, cam1.json, extrinsics.json equal run 0's byte for byte")
        runs.append(rec)
    n = torch.cuda.device_count()
    for i, visible in enumerate((None, "0") if n > 1 else (), start=len(runs)):
        tag = (f"[fresh {i}, CCRS_PREWARM=0, graphs, "
               f"{'CUDA_VISIBLE_DEVICES=0' if visible else f'{n} cards visible'}] ({card})")
        out = os.path.join(tmp, f"fresh{i}")
        rec, _ = fresh_run(tmp, ds, gt, tag, out, "0", "graphs",
                           {"CUDA_VISIBLE_DEVICES": visible} if visible else None)
        p_rel = max(float(np.max(np.abs(model_from_json(os.path.join(out, f"cam{c}.json")).params
                                        - model_from_json(os.path.join(tmp, "fresh0",
                                                                       f"cam{c}.json")).params)
                                 / np.abs(model_from_json(os.path.join(
                                     tmp, "fresh0", f"cam{c}.json")).params)))
                    for c in range(2))
        ext = [RvecTvec.from_json(object_from_json(os.path.join(d, "extrinsics.json"))["rtvecs"][1])
               for d in (out, os.path.join(tmp, "fresh0"))]
        e_abs = float(np.max(np.abs(np.concatenate([ext[0].rvec - ext[1].rvec,
                                                    ext[0].tvec - ext[1].tvec]))))
        joint_s = sum(rec["stages"].get(k, float("nan"))
                      for k in ("joint/init-extrinsic", "joint/ba"))
        print(f"{tag} joint_ba {joint_s:.3f} s; against run "
              f"0: parameters max rel diff {p_rel:.3e}, extrinsic max diff {e_abs:.3e}")
        if not (p_rel < 1e-8 and e_abs < 1e-8):
            raise RuntimeError(f"{tag} left run 0's result: {p_rel:.3e}, {e_abs:.3e}")
        runs.append(dict(rec, visible=visible or f"{n} cards", params_rel=p_rel, ext_abs=e_abs))
    walls = {}
    for r in runs:
        key = f"CCRS_PREWARM={r['prewarm']}, {r['mode']}" + (
            f", {r['visible']} visible" if "visible" in r else "")
        walls.setdefault(key, []).append(r["wall_s"])
    print(f"[fresh] ({card}) process wall: " + "; ".join(
        f"{k}: {', '.join(f'{t:.3f}' for t in v)} s" for k, v in walls.items())
        + " (in turns; no gate on time)")
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
    """bench_multicam.py's joint BA at full size through the float64 (its
    solver eager: the solver phase replays it as graphs) and the
    mixed-precision solver and through the sharded mixed solver, then the
    512 phase's final problem through ``ba_solve`` and ``ba_solve_mixed``.
    Returns (the numbers it printed, the eager float64 solve: result,
    seconds, iterations)."""
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
        # the float64 solve eagerly: the solver phase replays it as graphs
        with solvers_eager() if name == "float64" else contextlib.nullcontext():
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
    rig_eager = dict(result=results["float64"], seconds=solves[0]["seconds"],
                     iters=solves[0]["iters"])
    return dict(problem=dict(RIG, residuals=solves[0]["residuals"], reduced_dim=M),
                solves=solves, rms_mixed_minus_f64=d_rms, sharded_theta_rel=rel,
                single_512=single, single_512_rms_spread=spread), rig_eager


def stage_at(path, line):
    """The ``with stage("...")`` block of ``path`` that holds ``line`` (the
    nearest such line above it, indented less), or None."""
    with open(path) as f:
        lines = f.read().splitlines()
    depth = len(lines[line - 1]) - len(lines[line - 1].lstrip())
    for text in reversed(lines[: line - 1]):
        ind = len(text) - len(text.lstrip())
        if text.strip() and ind < depth:
            m = re.match(r'\s*with stage\("([^"]+)"\)', text)
            if m:
                return m.group(1)
            if text.lstrip().startswith("def "):
                return None
            depth = ind
    return None


def first_sync(torch, fn):
    """Run fn under ``torch.cuda.set_sync_debug_mode("error")``: torch
    raises at the first synchronizing CUDA call it knows of (a blocking
    copy, ``.item()``, a stream or device synchronize; a wait on a CUDA
    event is not one).  Returns None when fn completes without one, else
    {site, via, stage}: the Python line that made it, the line of
    ``_detect_batch_cold`` it was reached from and that line's stage
    timer.  A blocking ``.item()`` after fn is the control: the run fails
    unless torch raises on it too."""
    import traceback

    from ccrs_tpu_torch.detect import detector

    found = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            fn()
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
            tb = traceback.extract_tb(e.__traceback__)
            via = [fr.lineno for fr in tb if fr.filename == detector.__file__
                   and fr.name == "_detect_batch_cold"]
            found = dict(site=f"{os.path.relpath(tb[-1].filename)}:{tb[-1].lineno}",
                         via=f"detect/detector.py:{via[-1]}" if via else None,
                         stage=stage_at(detector.__file__, via[-1]) if via else None)
        try:
            torch.ones(1, device="cuda").item()
        except RuntimeError as e:
            if "synchronizing" not in str(e):
                raise
        else:
            raise RuntimeError("set_sync_debug_mode('error') let the control .item() pass")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return found


def run_pipeline_phase(card, frames512, cli_frames, board):
    """The cold detector's chunk pipeline against one chunk per call with
    the same chunk boundaries, on the 512 sequence and on both cli
    cameras: bit-equal detections, the best of 3 warm walls of each (in
    turns), the ``detect/*`` stage totals, busy share, peak memory and a
    synchronizing call of one pipelined chunk; the peak memory at 128 and
    534 frames (flat within ``FLAT_MIB``); then the tracked 512 main path
    with the natural and the JAX accelerator chunk plan.  Returns (the
    phase's numbers, the threshold launches of the pipelined and tracked
    runs)."""
    import torch

    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.utils import profiling

    with env_set(CCRS_TRACK="0"):
        det = TagDetector("t36h11", device="cuda")
    if det.track:
        raise RuntimeError("CCRS_TRACK=0 left the detector tracking")

    def pipelined(seqs):
        return [r for seq in seqs for r in det.detect_batch(None, board, dev_images=seq)]

    def chunk_by_chunk(seqs):
        return [r for seq in seqs for lo, n in chunk_spans(seq.shape[0])
                for r in det.detect_batch(None, board, dev_images=seq[lo : lo + n])]

    datasets = [
        (f"{N_512}x512x512", [frames512]),
        (f"2 cameras x {N_CLI}x480x752", [torch.as_tensor(f).cuda() for f in cli_frames]),
    ]
    result, launches = {"datasets": []}, 0
    for label, seqs in datasets:
        tag = f"[pipeline {label}] ({card})"
        plans = ["+".join(str(n) for _, n in chunk_spans(s.shape[0])) for s in seqs]
        ref = chunk_by_chunk(seqs)  # warm, and the reference
        threshold_front_cuda.launches = 0
        got = pipelined(seqs)
        launched = threshold_front_cuda.launches
        same_detections(got, ref, tag, "pipelined against chunk by chunk", exact=True)
        if launched <= 0:
            raise RuntimeError(f"{tag} the pipeline never launched the threshold kernel")
        launches += launched
        runs = {"pipelined": [], "chunk_by_chunk": []}
        for mode in ("pipelined", "chunk_by_chunk", "chunk_by_chunk", "pipelined",
                     "pipelined", "chunk_by_chunk"):
            fn = pipelined if mode == "pipelined" else chunk_by_chunk
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            profiling.reset()
            threshold_front_cuda.launches = 0
            out, wall = sync_time(torch, lambda: fn(seqs))
            if mode == "pipelined":
                launches += threshold_front_cuda.launches
            same_detections(out, ref, tag, f"{mode} warm run", exact=True)
            runs[mode].append(dict(
                wall_s=wall, stages_s={k: v for k, v in profiling.totals().items()
                                       if k.startswith("detect/")},
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                peak_above_input_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
            ))
        b, w, _ = device_busy_share(torch, lambda: pipelined(seqs))
        busy = dict(busy_s=b, wall_s=w, share=b / w if b > 0 else None)
        entry = dict(dataset=label, plan=plans, frames=len(ref),
                     tags=sum(len(r) for r in ref), busy_pipelined=busy)
        for mode, rs in runs.items():
            best = min(rs, key=lambda r: r["wall_s"])
            entry[mode] = dict(walls_s=[r["wall_s"] for r in rs], best_s=best["wall_s"],
                               stages_s=best["stages_s"],
                               peak_mib=max(r["peak_mib"] for r in rs),
                               peak_above_input_mib=max(r["peak_above_input_mib"] for r in rs))
            walls = ", ".join(f"{r['wall_s']:.3f}" for r in rs)
            print(f"{tag} {mode}: walls {walls} s, "
                  f"best {best['wall_s']:.3f} s; peak memory {entry[mode]['peak_mib']:.1f} MiB "
                  f"({entry[mode]['peak_above_input_mib']:.1f} above the frames)")
            for name, sec in sorted(best["stages_s"].items(), key=lambda kv: -kv[1]):
                print(f"{tag}   {mode} {name:18s} {sec:8.4f} s")
        print(f"{tag} chunk plan per sequence {plans}; detections equal bit for bit in "
              f"every run; {entry['tags']} (frame, tag) pairs; pipelined under "
              f"torch.profiler: device busy {b:.3f} s of {w:.3f} s wall")
        result["datasets"].append(entry)

    # a synchronizing call that one pipelined 64-frame chunk still makes
    one = frames512[:64].contiguous()
    det.detect_batch(None, board, dev_images=one)
    sync = first_sync(torch, lambda: det.detect_batch(None, board, dev_images=one))
    if sync is None:
        print(f"[pipeline sync] ({card}) a 64-frame chunk ran to its end under "
              f"set_sync_debug_mode('error'): torch saw no synchronizing call in it")
    else:
        print(f"[pipeline sync] ({card}) first synchronizing call in a 64-frame chunk: "
              f"{sync['site']}, reached from {sync['via']} in {sync['stage']}")
    result["first_sync_one_chunk"] = sync

    # peak memory above the frames against the batch size
    peak = {}
    for n in (128, N_512):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        threshold_front_cuda.launches = 0
        det.detect_batch(None, board, dev_images=frames512[:n])
        torch.cuda.synchronize()
        launches += threshold_front_cuda.launches
        peak[n] = (torch.cuda.max_memory_allocated() - base) / 2**20
    grew = peak[N_512] - peak[128]
    print(f"[pipeline memory] ({card}) peak above the frames, pipelined: 128 frames "
          f"{peak[128]:.1f} MiB, {N_512} frames {peak[N_512]:.1f} MiB (grew {grew:.1f}, "
          f"limit {FLAT_MIB})")
    if grew > FLAT_MIB:
        raise RuntimeError(f"[pipeline memory] peak memory grew {grew:.1f} MiB from 128 to "
                           f"{N_512} frames (limit {FLAT_MIB})")
    result["peak_above_input_mib_by_frames"] = {str(n): v for n, v in peak.items()}

    # the natural plan against the JAX accelerator plan's 8-frame tail
    # pieces in the tracked main path's sweeps
    from ccrs_tpu_torch.detect import graphs

    tracked = {}
    for plan, env in (("natural", {}), ("jax_plan", {"CCRS_FORCE_CHUNK_PLAN": "1"})):
        with env_set(**env), graphs.eager():  # the plans of eager torch (graphs: graphs phase)
            run = main_path(512, N_512, frames512, board, card,
                            f"[pipeline tracked, eager, {plan} chunk plan] ({card})")
        launches += run["launches"]
        tracked[plan] = dict(wall_s=run["t_total"], stats=run["stats"],
                             stages_s=run["stages"])
    print(f"[pipeline tracked] ({card}) eager main path walls: natural plan "
          f"{tracked['natural']['wall_s']:.3f} s, CCRS_FORCE_CHUNK_PLAN=1 "
          f"{tracked['jax_plan']['wall_s']:.3f} s")
    result["tracked_chunk_plan"] = tracked
    return result, launches


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


def card_graphs():
    """{card: [graphs held, MiB their captures added to the card's reserved
    memory]} over the graph cache."""
    from ccrs_tpu_torch import graphs

    out = {}
    for g in list(graphs._cache.values()):
        entry = out.setdefault(str((g.inputs or g.bound)[0].device), [0, 0.0])
        entry[0] += 1
        entry[1] += g.pool_bytes / 2**20
    return out


def compare_shard_routes(card, tag, solve, forced, n_shards):
    """``solve()``, a frame-sharded solve, through the per-shard route
    (``lm._shard_loop``: per-shard graphs and the copies between them; on
    one card inside ``lm.shard_graphs()``) against the eager sharded route
    (``graphs.eager()``): a first run from an empty graph cache (captures
    and pools per card), a second that must capture nothing, then eager
    and per-shard in turns (eager, shards, shards, eager, eager, shards):
    results and iterations equal bit for bit to the first run; best of 3
    walls and the spread; one profiled run of each: host launch calls
    (kernel and graph launches) and copy calls per LM iteration, card ms
    per iteration, host reads.  The per-shard route must make at most 10
    launch and copy calls per shard per iteration, plus 5.  Returns
    (numbers, failures)."""
    import torch

    from ccrs_tpu_torch import graphs
    from ccrs_tpu_torch.solve import lm

    def scope(mode):
        return graphs.eager() if mode == "eager" else lm.shard_graphs(forced)

    def run(mode):
        with scope(mode):
            lm.reset_loop_counts()
            out, wall = sync_time(torch, solve)
            return out, wall, lm.loop_counts()

    failed = []
    graphs.reset()
    torch.cuda.empty_cache()
    graphs.reset_counts()
    first, t_first, loops = run("shards")
    counts, held = graphs.counts(), card_graphs()
    graphs.reset_counts()
    _, t_second, _ = run("shards")
    second = graphs.counts()["captures"]
    if second:
        failed.append(f"{tag} the second per-shard run captured {second} graphs")
    if loops["routes"]["shards"] != loops["solves"]:
        failed.append(f"{tag} not every solve took the per-shard route: {loops}")
    ref = result_bits(first)
    runs = {"eager": [], "shards": []}
    for mode in ("eager", "shards", "shards", "eager", "eager", "shards"):
        out, wall, lp = run(mode)
        if not same_bits(result_bits(out), ref) or lp["iters"] != loops["iters"]:
            failed.append(f"{tag} {mode} differs from the first per-shard run (iterations "
                          f"{lp['iters']} against {loops['iters']})")
        runs[mode].append(dict(wall_s=wall, **lp))
    spread = max(max(r["wall_s"] for r in rs) - min(r["wall_s"] for r in rs)
                 for rs in runs.values())
    entry = dict(first_run=dict(wall_s=t_first, captures=counts["captures"],
                                capture_s=counts["capture_s"], graphs_by_card=held),
                 second_run_s=t_second, spread_s=spread)
    print(f"{tag} per-shard route, first run {t_first:.4f} s: {counts['captures']} captures in "
          f"{counts['capture_s']:.3f} s; per card (graphs, pool MiB) "
          f"{ {d: (n, round(mib, 1)) for d, (n, mib) in held.items()} }; second run "
          f"{t_second:.4f} s captured {second}")
    for mode, rs in runs.items():
        with scope(mode):
            lm.reset_loop_counts()
            prof = profile_run(torch, solve)
            lp = lm.loop_counts()
        per = max(lp["iters"], 1)
        e = entry[mode] = dict(
            walls_s=[r["wall_s"] for r in rs], best_s=min(r["wall_s"] for r in rs),
            iters=lp["iters"], reads=lp["chunks"], masked=lp["masked"], solves=lp["solves"],
            routes=lp["routes"], launch_calls=prof["launch_calls"],
            copy_calls=prof["copy_calls"],
            calls_per_iter=(prof["launch_calls"] + prof["copy_calls"]) / per,
            device_ms_per_iter=prof["busy_s"] * 1e3 / per,
            device_ms_per_iter_by_card={str(d): b * 1e3 / per
                                        for d, b in prof["busy_by_card_s"].items()},
            busy_share=prof["busy_s"] / prof["wall_s"])
        print(f"{tag} {mode}: walls {', '.join(f'{w:.4f}' for w in e['walls_s'])} s, best "
              f"{e['best_s']:.4f} s; {e['iters']} LM iterations in {e['solves']} solves, "
              f"{e['reads']} host reads, {e['masked']} masked; host calls {prof['launch_calls']} "
              f"launches + {prof['copy_calls']} copies ({e['calls_per_iter']:.1f} per iteration); "
              f"card {e['device_ms_per_iter']:.3f} ms per iteration (by card "
              f"{ {d: round(v, 3) for d, v in e['device_ms_per_iter_by_card'].items()} }), "
              f"busy {e['busy_share']:.1%} of {prof['wall_s']:.4f} s")
    limit = 10 * n_shards + 5
    entry["calls_limit_per_iter"] = limit
    print(f"{tag} best per-shard {entry['shards']['best_s']:.4f} s, eager "
          f"{entry['eager']['best_s']:.4f} s, spread {spread:.4f} s; results and n_iters equal "
          f"bit for bit in every run; per-shard calls per iteration "
          f"{entry['shards']['calls_per_iter']:.1f} (limit {limit}), eager "
          f"{entry['eager']['calls_per_iter']:.1f}")
    if entry["shards"]["calls_per_iter"] > limit:
        failed.append(f"{tag} {entry['shards']['calls_per_iter']:.1f} host calls per iteration "
                      f"on the per-shard route (limit {limit})")
    return entry, failed


def mesh_rig(card, mesh, forced):
    """bench_multicam.py's rig (8 cameras x 1000 frames, float64) through
    ``multi_ba_sharded`` on the mesh (per-shard route; forced on one card)
    against ``ba_solve_multi`` on one card, both graphed and warm (a first
    run of each captures): walls and iterations, the rig's gates, and the
    RMS within 1e-6 px of the one-card solve's (the interchange target:
    the shards sum in another order, so the flat optimum's 1e-14 relative
    stop may fall at another iteration; theta's difference is printed)."""
    import torch

    from ccrs_tpu_torch import graphs
    from ccrs_tpu_torch.models.projections import project_fn
    from ccrs_tpu_torch.parallel import mesh as pmesh
    from ccrs_tpu_torch.solve import lm
    from ccrs_tpu_torch.testdata import rig_errors, rig_problem

    tag = f"[mesh rig {RIG['n_cams']}x{RIG['n_frames']} float64, {len(mesh)} shards] ({card})"
    proj = project_fn("eucm")
    problem = rig_problem(seed=0, device="cuda", **RIG)
    args = problem["args"]
    out = {}
    for name, fn in (("one card", lambda: lm.ba_solve_multi(proj, *args)),
                     ("sharded", lambda: pmesh.multi_ba_sharded(proj, *args, mesh=mesh))):
        graphs.reset()
        torch.cuda.empty_cache()
        with lm.shard_graphs(forced and name == "sharded"):
            _, first = sync_time(torch, fn)
            lm.reset_loop_counts()
            res, wall = sync_time(torch, fn)
            loops = lm.loop_counts()
        err = rig_errors(problem, res)
        out[name] = dict(first_s=first, wall_s=wall, iters=res.n_iters, routes=loops["routes"],
                         reads=loops["chunks"], theta=res.theta, **err)
        print(f"{tag} {name}: first run {first:.3f} s (captures), warm {wall:.3f} s, "
              f"{res.n_iters} iterations, {loops['chunks']} host reads, routes {loops['routes']}; "
              f"focal err {err['focal_rel_err']:.3e}, extrinsic err {err['ext_err']:.3e}, "
              f"rms {err['rms_px']:.9f} px")
        if not (err["focal_rel_err"] < 3e-3 and err["ext_err"] < 3e-3
                and 0.07 < err["rms_px"] < 0.13):
            raise RuntimeError(f"{tag} {name} missed the rig's gates: {err}")
    one, sh = out["one card"].pop("theta"), out["sharded"].pop("theta")
    rel = float(((sh - one).abs() / one.abs()).max())
    d_rms = abs(out["sharded"]["rms_px"] - out["one card"]["rms_px"])
    per = {k: v["wall_s"] * 1e3 / v["iters"] for k, v in out.items()}
    print(f"{tag} sharded warm {out['sharded']['wall_s']:.3f} s ({per['sharded']:.1f} ms per "
          f"iteration) against one card {out['one card']['wall_s']:.3f} s "
          f"({per['one card']:.1f} ms per iteration); |rms difference| {d_rms:.3e} px, theta "
          f"max rel diff {rel:.3e}")
    if not d_rms < 1e-6:
        raise RuntimeError(f"{tag} the sharded rig left the one-card optimum by {d_rms:.3e} px")
    if out["sharded"]["routes"]["shards"] != 1:
        raise RuntimeError(f"{tag} the sharded rig did not take the per-shard route")
    del problem, args
    graphs.reset()
    torch.cuda.empty_cache()
    return dict(out, theta_rel=rel, rms_diff_px=d_rms, ms_per_iter=per)


def run_mesh_phase(card, frames512, run512, board, joint):
    """The multi-device layer on the mesh of every visible card (two shards
    of cuda:0 when only one is visible): the 512 phase's final problem
    through ``make_ba_solver`` against ``ba_solve``, the cli phase's joint
    problem through the joint BA's sharded route (``multi_ba_sharded``)
    against its single-device route and a CPU float64 re-solve; both
    problems through the per-shard route against the eager sharded route
    (``compare_shard_routes``; on one card the per-shard route is forced),
    the rig sharded against one card (``mesh_rig``); and the first
    N_MESH_DETECT frames of the 512 sequence through
    ``TagDetector(shard=True)``, tracked and cold, against the unsharded
    detector.  Returns (numbers, the threshold launches of the sharded
    detections)."""
    import torch

    from ccrs_tpu_torch.calib import multi
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.models.projections import project_fn
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.parallel import mesh as pmesh
    from ccrs_tpu_torch.solve.lm import ba_solve

    t_phase = time.perf_counter()
    mesh = pmesh.make_mesh()
    if len(mesh) == 1:
        mesh = [mesh[0], mesh[0]]
    n_cards = len({str(d) for d in mesh})
    forced = n_cards == 1
    tag = f"[mesh {len(mesh)} shards on {n_cards} card(s)] ({card})"
    print(f"{tag} mesh {[str(d) for d in mesh]}, {n_cards} distinct card(s)")
    n = torch.cuda.device_count()
    peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
             for i in range(n) for j in range(n) if i != j}
    print(f"{tag} peer access between cards: {peers or 'one card'}")
    result, failed = dict(mesh=[str(d) for d in mesh], peer_access=peers), []

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
    result["single"], bad = compare_shard_routes(
        card, f"{tag} single camera, {F} frames,", lambda: pmesh.make_ba_solver(proj, mesh)(
            theta0, poses_p, p3d, p2d_p, w_p, lo, hi, free, fv_p), forced, len(mesh))
    failed += bad

    # the joint BA: its sharded route against its single-device route
    routed, calls = [], []
    real = multi.multi_ba_sharded
    multi.multi_ba_sharded = lambda *a, **k: routed.append(len(k["mesh"])) or calls.append(
        (a, k)) or real(*a, **k)
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
    # the joint BA's sharded solve as the CLI's route calls it
    a, k = calls[0]
    result["joint"], bad = compare_shard_routes(
        card, f"{tag} joint BA,", lambda: real(*a, **k), forced, len(mesh))
    failed += bad
    result["rig"] = mesh_rig(card, mesh, forced)

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
    print(f"{tag} phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:  # after the measurements, so that a failed run still shows them
        raise RuntimeError("mesh phase gates failed: " + "; ".join(failed))
    return result, launches


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


@contextlib.contextmanager
def record_sampling():
    """Record the first call of each of the four ``detect/sample.py``
    functions and of the dense decode core (arguments and result), where
    the detector and the wave step reach them; the calls still run."""
    from ccrs_tpu_torch.detect import decode, sample
    from ccrs_tpu_torch.detect import track as track_mod

    seen = {}
    patched = []

    def wrap(module, name):
        real = getattr(module, name)

        def recorded(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.setdefault(name, (args, kwargs, out))
            return out

        patched.append((module, name, real))
        setattr(module, name, recorded)

    for name in SAMPLING_FUNCS:
        wrap(sample, name)
        if hasattr(track_mod, name):
            wrap(track_mod, name)
    wrap(decode, "_decode_core_dense")
    wrap(track_mod, "_decode_core_dense")
    try:
        yield seen
    finally:
        for module, name, real in reversed(patched):
            setattr(module, name, real)


def branch_detections(got, want, tag, truth=None):
    """The matmul branch's detections (``got``) against the gather
    branch's: ids equal in every frame, at least ``BRANCH_CORNER_SHARE`` of
    the common corners within ``BRANCH_CORNER_TOL`` px and all within
    ``BRANCH_CORNER_MAX`` px.  ``truth(f)``, where given, is frame f's
    projected board corners (N, 2): each corner beyond the tolerance is
    printed with its distance to the nearest true corner in both branches.
    Returns the counts and "failed" (None or why)."""
    diffs, id_frames, worst, apart = [], [], (0.0, None, None), []
    for f, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w):
            id_frames.append((f, sorted(set(g) ^ set(w))))
        for t in set(g) & set(w):
            gt_, wt = np.asarray(g[t]), np.asarray(w[t])
            d = np.abs(gt_ - wt).max(axis=1)
            diffs.append(d)
            if d.max() > worst[0]:
                worst = (float(d.max()), f, int(t))
            if truth is not None and d.max() >= BRANCH_CORNER_TOL:
                p2d = truth(f)
                k = int(d.argmax())
                off = [float(np.sqrt(((c[k] - p2d) ** 2).sum(-1)).min()) for c in (gt_, wt)]
                apart.append(dict(frame=f, tag=int(t), diff_px=float(d[k]),
                                  matmul_off_truth_px=off[0], gather_off_truth_px=off[1]))
    d = np.concatenate(diffs) if diffs else np.zeros(0)
    within = float((d < BRANCH_CORNER_TOL).mean()) if d.size else 1.0
    out = dict(frames=len(got), corners=int(d.size), within_tol_share=within,
               over_tol=int((d >= BRANCH_CORNER_TOL).sum()), max_px=worst[0],
               worst_frame_tag=worst[1:], frames_with_other_ids=len(id_frames),
               other_ids=id_frames[:5], apart_vs_truth=apart[:20])
    print(f"{tag} matmul against gather branch: {out['corners']} common corners, "
          f"{out['over_tol']} beyond {BRANCH_CORNER_TOL} px ({1 - within:.4%}), max "
          f"{worst[0]:.3e} px (frame, tag {worst[1:]}); frames whose ids differ: "
          f"{len(id_frames)} {id_frames[:5]}")
    for a in apart[:20]:
        print(f"{tag}   frame {a['frame']} tag {a['tag']}: branches {a['diff_px']:.3e} px apart; "
              f"nearest true corner {a['matmul_off_truth_px']:.3f} px (matmul), "
              f"{a['gather_off_truth_px']:.3f} px (gather)")
    why = []
    if id_frames:
        why.append(f"ids differ in {len(id_frames)} frames")
    if len(got) != len(want):
        why.append(f"{len(got)} frames against {len(want)}")
    if within < BRANCH_CORNER_SHARE or worst[0] >= BRANCH_CORNER_MAX:
        why.append(f"corners: {within:.4%} within {BRANCH_CORNER_TOL} px, max {worst[0]:.3e}")
    out["failed"] = f"{tag}: " + ", ".join(why) if why else None
    return out


def tol_excess(got, want, rtol, atol):
    """(max |got - want|, max of |got - want| - atol - rtol |want|): the
    comparison holds where the second is <= 0."""
    d = (got - want).abs()
    return float(d.max()) if d.numel() else 0.0, \
        float((d - atol - rtol * want.abs()).max()) if d.numel() else -1.0


def check_sampling_functions(torch, seen, label, card):
    """The four functions on the recorded inputs, on the card through both
    branches (``SAMPLING_BRANCH_TOL``), and the first ``N_SAMPLING_CPU``
    frames or rows through the matmul branch on the CPU against the card's
    (``SAMPLING_CPU_TOL``).  Refined corners are held where the recorded
    decode found a valid tag; the largest difference over every corner is
    printed beside it."""
    from ccrs_tpu_torch.detect import sample

    tag = f"[sampling {label}] ({card})"
    dec_args, _, dec_out = seen["_decode_core_dense"]
    valid = dec_out["valid"]  # (B, M) quads the recorded decode accepted
    rec = {}
    for name in SAMPLING_FUNCS:
        args, kwargs, _ = seen[name]
        fn = getattr(sample, name)
        kw = {k: v for k, v in kwargs.items() if k != "use_matmul"}
        mm = fn(*args, use_matmul=True, **kw)
        ga = fn(*args, use_matmul=False, **kw)
        n = N_SAMPLING_CPU
        cpu = fn(*[a[:n].cpu() if torch.is_tensor(a) else a for a in args],
                 use_matmul=True, **kw)
        torch.cuda.synchronize()
        mask = None
        if name == "refine_corners_mm":
            mask = valid.repeat_interleave(4, dim=1)  # (B, 4M) corners
        r_b, a_b = SAMPLING_BRANCH_TOL[name]
        r_c, a_c = SAMPLING_CPU_TOL[name]
        err_all, _ = tol_excess(mm, ga, r_b, a_b)
        sel = (lambda x: x[mask]) if mask is not None else (lambda x: x)
        err_b, over_b = tol_excess(sel(mm), sel(ga), r_b, a_b)
        mm_cpu = mm[:n].cpu()
        sel_c = (lambda x: x[mask[:n].cpu()]) if mask is not None else (lambda x: x)
        err_c, over_c = tol_excess(sel_c(cpu), sel_c(mm_cpu), r_c, a_c)
        shape = "x".join(str(d) for d in args[0].shape)
        what = (f" (corners of the {int(valid.sum())} decoded quads; every corner "
                f"{err_all:.3e})" if mask is not None else "")
        print(f"{tag} {name} on {shape}: matmul vs gather max diff {err_b:.3e}{what}, "
              f"tolerance rtol {r_b} atol {a_b}; card vs CPU matmul on {n}: {err_c:.3e}, "
              f"tolerance rtol {r_c} atol {a_c}")
        if over_b > 0 or over_c > 0 or mm.shape != ga.shape or cpu.shape != mm_cpu.shape:
            raise RuntimeError(f"{tag} {name}: the branches or the devices disagree")
        rec[name] = dict(shape=shape, matmul_vs_gather=err_b, card_vs_cpu=err_c,
                         every_corner=err_all if mask is not None else None)
    # the matmul refine reads build_klt_maps' layout as it is: no kernel of
    # its 12 steps copies the maps (or anything else)
    args, kwargs, _ = seen["refine_corners_mm"]
    for mm in (True, False):
        _, _, names = device_busy_share(
            torch, lambda: sample.refine_corners_mm(*args, use_matmul=mm))
        copies = sum("direct_copy" in n for n in names)
        rec["refine_corners_mm"][f"{branch_name(mm)}_kernels"] = len(names)
        rec["refine_corners_mm"][f"{branch_name(mm)}_copy_kernels"] = copies
        print(f"{tag} refine_corners_mm, {branch_name(mm)} branch: {len(names)} CUDA kernels in "
              f"one call of {sample.ITERS} steps, {copies} of them copies (torch.profiler)")
        if mm and copies:
            raise RuntimeError(f"{tag} the matmul refine launched {copies} copy kernels")
    return rec


def saddle_check(torch, card):
    """A checkerboard saddle at (31.3, 32.6) on the card: both branches
    refine a 1.2 / -1.4 px off start to within 0.05 px."""
    from ccrs_tpu_torch.detect import sample

    H = W = 64
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 127.5 + 127.5 * np.tanh(0.9 * (xx - 31.3)) * np.tanh(0.9 * (yy - 32.6))
    frames = torch.as_tensor(img[None], device="cuda")
    start = torch.tensor([[[31.3 + 1.2, 32.6 - 1.4]]], device="cuda")
    out = {}
    for mm in (True, False):
        maps = sample.build_klt_maps(frames, use_matmul=mm)
        got = sample.refine_corners_mm(maps, start, use_matmul=mm)[0, 0].cpu().numpy()
        out[branch_name(mm)] = float(np.abs(got - np.array([31.3, 32.6])).max())
    print(f"[sampling saddle] ({card}) refined saddle off the truth by {out} px (limit 0.05)")
    if max(out.values()) >= 0.05:
        raise RuntimeError(f"[sampling saddle] ({card}) a branch missed the saddle: {out}")
    return out


def batch_check(torch, det, frames, board, card):
    """The first 64 frames through the cold detector in one call, and in
    calls of 32 and of 8, in each branch: do a frame's corners depend on
    the frames it is batched with?  The gather branch must not (the mesh
    phase's sharded detection relies on it); the matmul branch's products
    may round otherwise when cuBLAS picks another algorithm for another
    shape, and its difference is printed."""
    from ccrs_tpu_torch.detect import sample

    tag = f"[sampling batch] ({card})"
    out = {}
    for mm in (True, False):
        ids, diff = True, 0.0
        with sample.matmul_branch(mm):
            whole = det.detect_batch(None, board, dev_images=frames[:64].contiguous())
            for n in (32, 8):
                parts = [r for lo in range(0, 64, n) for r in det.detect_batch(
                    None, board, dev_images=frames[lo : lo + n].contiguous())]
                ids &= all(sorted(a) == sorted(b) for a, b in zip(whole, parts))
                diff = max([diff] + [float(np.abs(a[t] - b[t]).max())
                                     for a, b in zip(whole, parts) for t in set(a) & set(b)])
        out[branch_name(mm)] = dict(same_ids=ids, max_diff_px=diff)
        print(f"{tag} {branch_name(mm)} branch: 64 frames in one call against calls of 32 "
              f"and of 8: ids equal {ids}, corners max diff {diff:.3e} px")
    if not (out["gather"]["same_ids"] and out["gather"]["max_diff_px"] == 0.0):
        raise RuntimeError(f"{tag} the gather branch's detections depend on the batch")
    return out


def run_sampling_phase(card, frames512, frames1024, cli_frames, board):
    """``detect/sample.py``'s two branches on the card: (a) the four
    functions on one 64-frame chunk of the 512 frames with their quadproc
    quads and on one wave of the tracked 512 path, the matmul branch
    against the gather branch and against the CPU's matmul branch, and the
    synthetic saddle; (b) the cold detector and the tracked main path under
    each branch: ids equal, corners within ``BRANCH_CORNER_TOL`` (a
    ``BRANCH_CORNER_SHARE``; all within ``BRANCH_CORNER_MAX``), the 512
    calibration gates for both; (c) per branch, in turns, the best of 3
    warm walls, the ``detect/*`` stages, busy share, kernel launches and
    device time per cold chunk and per wave, peak memory above the frames,
    at 512, 1024 and on the cli frames.  Returns (numbers, threshold
    launches of its detections)."""
    import torch

    from ccrs_tpu_torch.detect import TagDetector, sample, tracked
    from ccrs_tpu_torch.detect import track as track_mod
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.testdata import gt_corners, smooth_sequence_poses
    from ccrs_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    default_mm = card_branch()
    result = {"default": branch_name(default_mm), "functions": {}}
    launches = 0

    # (a) the four functions at the main path's shapes
    def first_wave(frames):
        waves = []
        real = tracked.wave_advance
        tracked.wave_advance = lambda *a: (waves.append(a) if not waves else None) or real(*a)
        try:
            TagDetector("t36h11", device="cuda").detect_batch(None, board, dev_images=frames)
        finally:
            tracked.wave_advance = real
        return waves[0]

    cold = TagDetector("t36h11", track=False, device="cuda")
    chunk = frames512[:64].contiguous()
    with record_sampling() as seen:
        cold.detect_batch(None, board, dev_images=chunk)
    result["functions"]["chunk 64x512x512"] = check_sampling_functions(
        torch, seen, "chunk 64x512x512", card)
    del seen
    wave512 = first_wave(frames512)
    with record_sampling() as seen:
        track_mod.wave_advance(*wave512)
    rows = wave512[1].shape[0]
    result["functions"][f"wave {rows}x512x512"] = check_sampling_functions(
        torch, seen, f"wave {rows}x512x512", card)
    del seen
    result["saddle_px"] = saddle_check(torch, card)
    result["batch_independence"] = batch_check(torch, cold, frames512, board, card)
    torch.cuda.empty_cache()
    print(f"[sampling] ({card}) function checks took {time.perf_counter() - t_phase:.1f} s")

    # (b) and (c): both branches in turns, per dataset
    s2 = [p * 2 for p in GT_512[:4]] + GT_512[4:]
    datasets = [
        ("534x512x512", [frames512], 512, GenericModel("eucm", GT_512, 512, 512)),
        ("128x1024x1024", [frames1024], 1024, GenericModel("eucm", s2, 1024, 1024)),
        (f"2 cameras x {N_CLI}x480x752", [torch.as_tensor(f).cuda() for f in cli_frames],
         None, None),
    ]

    def truth_of(seqs, gt):
        """Frame f's projected board corners (the 512 and 1024 phases'
        poses, run_phase's seed), or None for the cli frames."""
        if gt is None:
            return None
        poses = smooth_sequence_poses(seqs[0].shape[0], board, seed=SEED)
        return lambda f: gt_corners(gt, board, poses[f][:3], poses[f][3:])[0]

    order = (True, False, False, True, True, False)
    decide, failed, beyond = {}, [], {True: [], False: []}
    result["datasets"] = []
    for label, seqs, size, gt in datasets:
        entry = dict(dataset=label)
        kinds = [("cold", None)] + ([("tracked main path", size)] if size else [])
        for kind, sz in kinds:
            tag = f"[sampling {label}, {kind}] ({card})"
            runs = {True: [], False: []}
            for mm in order:
                with sample.matmul_branch(mm):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    if kind == "cold":
                        profiling.reset()
                        threshold_front_cuda.launches = 0
                        dets, wall = sync_time(torch, lambda: [
                            r for seq in seqs
                            for r in cold.detect_batch(None, board, dev_images=seq)])
                        run = dict(dets=dets, t_total=wall, stages=profiling.totals(),
                                   launches=threshold_front_cuda.launches)
                    else:
                        run = main_path(sz, seqs[0].shape[0], seqs[0], board, card,
                                        f"{tag} {branch_name(mm)}")
                    torch.cuda.synchronize()
                launches += run["launches"]
                run["peak_above_input_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
                if not runs[mm] and kind != "cold":
                    # (b) the 512 phase's calibration gates, for each branch
                    focal = abs(run["model"].params[0] - gt.params[0]) / gt.params[0]
                    print(f"{tag} {branch_name(mm)}: focal err {focal:.4%}, median "
                          f"{run['median']:.4f} px")
                    if not (focal < 0.01 and run["median"] < 0.3):
                        failed.append(f"{tag} {branch_name(mm)}: focal {focal:.2%} or "
                                      f"median {run['median']:.4f} px off")
                    try:
                        cpu_resolve_gate(board, run["batch"], run["model"], run["rtvecs"],
                                         f"{tag} {branch_name(mm)}")
                    except RuntimeError as e:
                        failed.append(str(e))
                runs[mm].append(run)
            # (b) the two branches detect the same tags: held at 512, printed
            # for the other datasets
            k_cmp = branch_detections(runs[True][0]["dets"], runs[False][0]["dets"], tag,
                                      truth_of(seqs, gt))
            if k_cmp["failed"] and size == 512:
                failed.append(k_cmp["failed"])
            spread = max(max(r["t_total"] for r in rs) - min(r["t_total"] for r in rs)
                         for rs in runs.values())
            k = {"matmul_vs_gather": {n: v for n, v in k_cmp.items() if n != "failed"}}
            for mm, rs in runs.items():
                best = min(rs, key=lambda r: r["t_total"])
                k[branch_name(mm)] = dict(
                    walls_s=[r["t_total"] for r in rs], best_s=best["t_total"],
                    stages_s={n: v for n, v in best["stages"].items() if n.startswith("detect/")},
                    peak_above_input_mib=max(r["peak_above_input_mib"] for r in rs),
                    stats=best.get("stats"))
                print(f"{tag} {branch_name(mm)}: walls "
                      f"{', '.join(f'{r['t_total']:.3f}' for r in rs)} s, best "
                      f"{best['t_total']:.3f} s; peak above the frames "
                      f"{k[branch_name(mm)]['peak_above_input_mib']:.1f} MiB")
                for n, v in sorted(k[branch_name(mm)]["stages_s"].items(), key=lambda kv: -kv[1]):
                    print(f"{tag}   {branch_name(mm)} {n:20s} {v:8.4f} s")
            # device busy share, one profiled run per branch (at 1024 of the
            # cold detector only)
            for mm in (True, False) if kind == "cold" or size == 512 else ():
                with sample.matmul_branch(mm):
                    if kind == "cold":
                        b, w, _ = device_busy_share(torch, lambda: [
                            cold.detect_batch(None, board, dev_images=seq) for seq in seqs])
                    else:
                        b, w, _ = device_busy_share(torch, lambda: main_path(
                            sz, seqs[0].shape[0], seqs[0], board, card, f"{tag} profiled"))
                k[branch_name(mm)]["busy"] = dict(busy_s=b, wall_s=w, share=b / w if b > 0 else None)
                print(f"{tag} {branch_name(mm)} under torch.profiler: device busy {b:.3f} s of "
                      f"{w:.3f} s wall")
            k["spread_s"] = spread
            entry[kind] = k
            print(f"{tag} best matmul {k['matmul']['best_s']:.3f} s, gather "
                  f"{k['gather']['best_s']:.3f} s, spread between runs {spread:.3f} s")
            gap = k["matmul"]["best_s"] - k["gather"]["best_s"]
            if abs(gap) > spread:
                beyond[gap > 0].append(f"{label} {kind}")
            if (label, kind) in (("534x512x512", "cold"), ("534x512x512", "tracked main path")):
                decide[kind] = gap > spread

        # launches and device time per cold chunk and per wave, each branch
        one = seqs[0][:64].contiguous()
        wave = (wave512 if size == 512 else first_wave(seqs[0])) if size else None
        for mm in (True, False):
            with sample.matmul_branch(mm):
                cold.detect_batch(None, board, dev_images=one)  # warm
                dev_chunk, _, k_chunk = device_busy_share(torch, lambda: cold.detect_batch(
                    None, board, dev_images=one))
                per = dict(chunk_kernels=len(k_chunk), chunk_device_s=dev_chunk)
                if wave is not None:
                    track_mod.wave_advance(*wave)
                    dev_wave, _, k_wave = device_busy_share(
                        torch, lambda: track_mod.wave_advance(*wave))
                    per.update(wave_rows=int(wave[1].shape[0]), wave_kernels=len(k_wave),
                               wave_device_s=dev_wave)
            entry.setdefault("per_call", {})[branch_name(mm)] = per
            print(f"[sampling {label}] ({card}) {branch_name(mm)}: {per} (torch.profiler; a "
                  f"cold chunk of {one.shape[0]} frames with its assist"
                  f"{', one wave' if wave is not None else ''})")
        result["datasets"].append(entry)
        torch.cuda.empty_cache()
        print(f"[sampling {label}] ({card}) done at {time.perf_counter() - t_phase:.1f} s")

    slower = [kind for kind, s_ in decide.items() if s_]
    rule = branch_name(not slower)
    result.update(rule_takes=rule, matmul_slower_beyond_spread=beyond[True],
                  matmul_faster_beyond_spread=beyond[False])
    print(f"[sampling default] ({card}) the card takes the {branch_name(default_mm)} branch by "
          f"default; this run's rule (keep gather if matmul's best of 3 is slower by more than "
          f"the spread between runs on the tracked 512 main path or the 534x512x512 cold "
          f"detector) takes {rule}" + (f": matmul slower on {slower}" if slower else "")
          + f"; matmul slower beyond the spread on {beyond[True]}, faster beyond it on "
          f"{beyond[False]}")
    if failed:  # after the measurements, so that a failed run still shows them
        raise RuntimeError("sampling phase gates failed: " + "; ".join(failed))
    return result, launches


@contextlib.contextmanager
def first_run_waves(log):
    """Append the arguments of the first ``tracked._run_waves`` call (the
    main sweep) inside the block to ``log``."""
    from ccrs_tpu_torch.detect import tracked

    real = tracked._run_waves

    def wrapper(*args):
        if not log:
            log.append(args)
        return real(*args)

    tracked._run_waves = wrapper
    try:
        yield log
    finally:
        tracked._run_waves = real


def natural_plan(self, B, chunk=None, device=None):
    """``TagDetector._plan`` with natural chunks on every device, each
    decoded at its own size (under graphs: one graph per chunk size)."""
    from ccrs_tpu_torch.detect.detector import _chunk_spans

    return [(lo, n, n) for lo, n in _chunk_spans(B, self.chunk, self.cold_chunk, True, chunk)]


def run_graphs_phase(card, frames512, frames1024, cli_frames, board):
    """The detect path's captured CUDA graphs (``detect/graphs.py``, the
    card's default) against eager (``graphs.eager()``) on five sets: the
    cold detector on 534 x 512^2, 128 x 1024^2 and the cli frames, and the
    tracked 512 and 1024 main paths.  Per set: a first run with graphs
    from an empty cache (captures, replays, capture seconds, pool MiB) and
    a second one (it must capture nothing); then eager and graphs in turns
    (eager, graphs, graphs, eager, eager, graphs): detections of every
    graphed run equal to the eager ones bit for bit, best of 3 warm walls
    and the spread, ``detect/*`` stages, peak memory above the frames;
    busy share (one profiled run each); host launch calls and device time
    per 64-frame cold chunk with its assist and per wave of the main
    sweep.  Then the default rule (graphs unless the tracked 512 main path
    or the 534 x 512^2 cold detector is slower with graphs by more than
    the spread), and the tracked 512 main path with natural chunks against
    the JAX plan, both with graphs.  Returns (numbers, threshold launches
    of its detections)."""
    import torch

    from ccrs_tpu_torch.detect import TagDetector, graphs, tracked
    from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
    from ccrs_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    cold = TagDetector("t36h11", track=False, device="cuda")
    sets = [
        (f"cold {N_512}x512x512", None, [frames512]),
        (f"cold {N_1024}x1024x1024", None, [frames1024]),
        (f"cold 2 cameras x {N_CLI}x480x752", None,
         [torch.as_tensor(f).cuda() for f in cli_frames]),
        ("tracked 512 main path", 512, [frames512]),
        ("tracked 1024 main path", 1024, [frames1024]),
    ]
    result, failed, launches = {"sets": []}, [], 0

    def run(size, seqs, label):
        """One run of the set: its detections, wall, stages, threshold
        launches and peak memory above the frames."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if size is None:
            profiling.reset()
            threshold_front_cuda.launches = 0
            dets, wall = sync_time(torch, lambda: [
                r for seq in seqs for r in cold.detect_batch(None, board, dev_images=seq)])
            out = dict(dets=dets, t_total=wall, stages=profiling.totals(),
                       launches=threshold_front_cuda.launches)
        else:
            out = main_path(size, seqs[0].shape[0], seqs[0], board, card, label)
        torch.cuda.synchronize()
        out["peak_above_input_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        return out

    decide = {}
    for label, size, seqs in sets:
        tag = f"[graphs {label}] ({card})"
        entry = dict(set=label)
        graphs.reset()
        torch.cuda.empty_cache()
        waves = {"graphs": [], "eager": []}
        counts = []
        for i in range(2):  # the first run from an empty cache, then the second
            graphs.reset_counts()
            with first_run_waves(waves["graphs"]) if i else contextlib.nullcontext():
                r = run(size, seqs, f"{tag} run {i + 1} with graphs")
            launches += r["launches"]
            counts.append(graphs.counts())
        entry.update(first_run=dict(counts[0], wall_s=r["t_total"]), second_run=counts[1])
        print(f"{tag} first run: {counts[0]['captures']} captures in "
              f"{counts[0]['capture_s']:.3f} s, {counts[0]['replays']} replays; second run "
              f"captured {counts[1]['captures']}, replayed {counts[1]['replays']}; "
              f"{counts[1]['graphs']} graphs held, pools {counts[1]['pool_mib']:.1f} MiB")
        if counts[1]["captures"] != 0 or counts[1]["replays"] == 0:
            failed.append(f"{tag} the second run captured {counts[1]['captures']} graphs "
                          f"(replayed {counts[1]['replays']})")
        runs = {"graphs": [], "eager": []}
        ref = None
        for mode in ("eager", "graphs", "graphs", "eager", "eager", "graphs"):
            record = first_run_waves(waves["eager"]) if mode == "eager" else None
            with graphs.eager(mode == "eager"), record or contextlib.nullcontext():
                r = run(size, seqs, f"{tag} {mode}")
            launches += r["launches"]
            if ref is None:
                ref = r["dets"]
            try:
                same_detections(r["dets"], ref, tag, f"{mode} against eager", exact=True)
            except RuntimeError as e:
                failed.append(str(e))
            runs[mode].append(r)
        spread = max(max(r["t_total"] for r in rs) - min(r["t_total"] for r in rs)
                     for rs in runs.values())
        for mode, rs in runs.items():
            best = min(rs, key=lambda r: r["t_total"])
            with graphs.eager(mode == "eager"):
                prof = profile_run(torch, lambda: run(size, seqs, f"{tag} {mode} profiled"))
            entry[mode] = dict(
                walls_s=[r["t_total"] for r in rs], best_s=best["t_total"],
                stages_s={n: v for n, v in best["stages"].items() if n.startswith("detect/")},
                peak_above_input_mib=max(r["peak_above_input_mib"] for r in rs),
                stats=best.get("stats"),
                busy=dict(busy_s=prof["busy_s"], wall_s=prof["wall_s"],
                          share=prof["busy_s"] / prof["wall_s"]),
            )
            print(f"{tag} {mode}: walls {', '.join(f'{r['t_total']:.3f}' for r in rs)} s, best "
                  f"{best['t_total']:.3f} s; busy {prof['busy_s']:.3f} s of {prof['wall_s']:.3f} s "
                  f"under torch.profiler ({prof['busy_s'] / prof['wall_s']:.1%}); peak above the "
                  f"frames {entry[mode]['peak_above_input_mib']:.1f} MiB")
            for n, v in sorted(entry[mode]["stages_s"].items(), key=lambda kv: -kv[1]):
                print(f"{tag}   {mode} {n:20s} {v:8.4f} s")
            # host launch calls and device time per cold chunk and per wave
            with graphs.eager(mode == "eager"):
                if size is None:
                    one = seqs[0][:64].contiguous()
                    cold.detect_batch(None, board, dev_images=one)  # warm
                    p = profile_run(torch, lambda: cold.detect_batch(None, board, dev_images=one))
                    entry[mode]["per_chunk"] = dict(
                        frames=64, launch_calls=p["launch_calls"],
                        graph_launches=p["graph_launches"], kernels=len(p["kernels"]),
                        device_ms=p["busy_s"] * 1e3)
                    print(f"{tag} {mode}, one 64-frame chunk with its assist: "
                          f"{entry[mode]['per_chunk']}")
                else:
                    args = waves[mode][0]
                    act = args[5]
                    n_waves = int(np.flatnonzero(act.any(axis=1)).max()) + 1
                    p = profile_run(torch, lambda: [t.cpu() for t in tracked._run_waves(*args)])
                    entry[mode]["per_wave"] = dict(
                        rows=int(act.shape[1]), waves=n_waves,
                        launch_calls=p["launch_calls"] / n_waves,
                        graph_launches=p["graph_launches"] / n_waves,
                        kernels=len(p["kernels"]) / n_waves,
                        device_ms=p["busy_s"] * 1e3 / n_waves)
                    print(f"{tag} {mode}, the main sweep's waves: {entry[mode]['per_wave']} "
                          "(per wave, the stack's copy to the host included)")
        entry["spread_s"] = spread
        gap = entry["graphs"]["best_s"] - entry["eager"]["best_s"]
        entry["graphs_minus_eager_s"] = gap
        print(f"{tag} best graphs {entry['graphs']['best_s']:.3f} s, eager "
              f"{entry['eager']['best_s']:.3f} s, spread between runs {spread:.3f} s; "
              f"detections equal bit for bit in every run")
        if label in (f"cold {N_512}x512x512", "tracked 512 main path"):
            decide[label] = gap > spread
        result["sets"].append(entry)
        print(f"[graphs] ({card}) {label} done at {time.perf_counter() - t_phase:.1f} s")

    slower = [k for k, v in decide.items() if v]
    rule = "eager" if slower else "graphs"
    result.update(rule_takes=rule, graphs_slower_beyond_spread=slower)
    print(f"[graphs default] ({card}) the card runs the detect path as graphs by default "
          f"(graphs.active: {graphs.active(torch.device('cuda'))}); this run's rule (eager if "
          f"graphs' best of 3 is slower by more than the spread on the tracked 512 main path "
          f"or the {N_512}x512x512 cold detector) takes {rule}"
          + (f": graphs slower on {slower}" if slower else ""))

    # natural chunks against the JAX plan, now with graphs: natural
    # pieces capture one decode graph per chunk size
    from ccrs_tpu_torch.detect.detector import TagDetector as TD

    graphs.reset()
    torch.cuda.empty_cache()
    real_plan = TD._plan
    plans = {"natural": [], "jax_plan": []}
    try:
        for plan in ("natural", "jax_plan", "jax_plan", "natural"):
            TD._plan = natural_plan if plan == "natural" else real_plan
            graphs.reset_counts()
            r = main_path(512, N_512, frames512, board, card,
                          f"[graphs tracked 512, {plan} chunks] ({card})")
            launches += r["launches"]
            plans[plan].append(dict(wall_s=r["t_total"], stats=r["stats"],
                                    captures=graphs.counts()["captures"]))
    finally:
        TD._plan = real_plan
    result["tracked_chunk_plan"] = plans
    print(f"[graphs tracked 512 chunk plan] ({card}) main path walls with graphs: natural "
          f"chunks {[p['wall_s'] for p in plans['natural']]} s (captures "
          f"{[p['captures'] for p in plans['natural']]}), JAX plan "
          f"{[p['wall_s'] for p in plans['jax_plan']]} s (captures "
          f"{[p['captures'] for p in plans['jax_plan']]})")
    graphs.reset()
    torch.cuda.empty_cache()
    print(f"[graphs] ({card}) phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:  # after the measurements, so that a failed run still shows them
        raise RuntimeError("graphs phase gates failed: " + "; ".join(failed))
    return result, launches


@contextlib.contextmanager
def solvers_eager():
    """Inside the block the solvers (``solve/lm.py``'s device loop and every
    ``graphs.call``) run eagerly on every thread while the detect path
    keeps its graphs: this script's own switch for the comparison, since
    ``graphs.eager()`` turns both off.  The shared core's ``active``
    answers False; the detect path reads its own binding of it."""
    from ccrs_tpu_torch import graphs

    real = graphs.active
    graphs.active = lambda where: False
    try:
        yield
    finally:
        graphs.active = real


def result_bits(out):
    """The numbers of a solver result, as numpy arrays for a bit-for-bit
    comparison: a BAResult / MultiBAResult (n_iters included), a model,
    (model, rtvecs), or a tuple of tensors."""
    import torch

    from ccrs_tpu_torch.models import GenericModel

    if out is None:
        return [np.array([np.nan])]
    if isinstance(out, GenericModel):
        return [out.params]
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], GenericModel):
        model, rtvecs = out
        frames = sorted(rtvecs)
        return [model.params, np.array(frames, float)] + [
            np.concatenate([rtvecs[f].rvec, rtvecs[f].tvec]) for f in frames]
    if hasattr(out, "n_iters"):
        return [t.cpu().numpy() for t in out[:-2 if hasattr(out, "n_polish") else -1]
                if isinstance(t, torch.Tensor)] + [np.array([out.n_iters, out.n_polish])]
    return [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in out]


def same_bits(a, b) -> bool:
    """Whether two ``result_bits`` lists hold the same bits."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def run_solver_phase(card, frames512, run512, board, rig_eager):
    """The calibration executables as captured graphs (``solve/lm.py``'s
    device loop, ``graphs.call``; the card's default) against eager on
    the problems of the 512 phase: its final ``ba_solve`` problem, one
    init attempt on its two init frames with fixed draws, ``convert_model``
    from the init's UCM to EUCM (analytic) and to KB4 (the grid fit's
    ``lm_solve``), ``calib_camera`` as the speculative solve and as the
    final solve call it (warm and cold); then the rig's float64 ``ba_solve_multi`` graphed against the rig
    phase's eager solve (``rig_eager``).  Per problem: a first run from an
    empty graph cache (captures, capture seconds, pools) and a second one
    (it must capture nothing), then eager and graphs in turns (eager,
    graphs, graphs, eager, eager, graphs): results bit-equal to eager,
    ``n_iters`` equal, best of 3 walls and the spread; one profiled run of
    each (host launch calls, card time and busy share, per LM iteration);
    the masked iterations.  Then the chunk length swept over
    ``SOLVER_KS`` on the 512 problem and the init attempt, and the 512
    main path, tracked and cold, with solver graphs against eager in turns
    after one untimed run of each (results bit-equal).  Returns (numbers,
    threshold launches)."""
    import torch

    from ccrs_tpu_torch import graphs
    from ccrs_tpu_torch.calib import calib_camera
    from ccrs_tpu_torch.calib.convert import convert_model
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.initialize import find_best_two_frames, try_init_camera
    from ccrs_tpu_torch.calib.pipeline import spec_stride
    from ccrs_tpu_torch.models import zeros_like_model
    from ccrs_tpu_torch.models.projections import project_fn
    from ccrs_tpu_torch.solve import lm
    from ccrs_tpu_torch.testdata import rig_problem

    t_phase = time.perf_counter()
    batch, model, rtvecs = run512["batch"], run512["model"], run512["rtvecs"]
    proj = project_fn("eucm")
    sargs = single_problem(board, batch, model, rtvecs, "cuda")
    f0, f1 = find_best_two_frames(batch)

    def init():
        gen = torch.Generator(device="cuda").manual_seed(INIT_DRAWS_SEED)
        return try_init_camera(board, batch, f0, f1, gen, device="cuda")

    with solvers_eager():
        ucm = init()
    if ucm is None:
        raise RuntimeError(f"[solver] ({card}) the init attempt on frames {f0}, {f1} failed")
    seed = zeros_like_model("eucm")
    seed.set_w_h(batch.width, batch.height)
    convert_model(ucm, seed, device="cuda")
    stride = spec_stride(batch.n_frames)
    sub = FrameBatch(batch.time_ns[::stride], batch.p2d[::stride], batch.mask[::stride],
                     batch.width, batch.height)
    F = batch.n_frames
    warm_poses, warm_valid = np.zeros((F, 6)), np.zeros(F)
    for f, rt in rtvecs.items():
        warm_poses[f], warm_valid[f] = np.concatenate([rt.rvec, rt.tvec]), 1.0

    def convert(name):
        tgt = zeros_like_model(name)
        tgt.set_w_h(batch.width, batch.height)
        convert_model(ucm, tgt, device="cuda")
        return tgt

    problems = [
        (f"ba_solve, 512 problem ({F} frames)", lambda: lm.ba_solve(proj, *sargs)),
        (f"try_init_camera, frames {f0} and {f1}", init),
        ("convert_model ucm -> eucm", lambda: convert("eucm")),
        ("convert_model ucm -> kb4", lambda: convert("kb4")),
        (f"calib_camera as the speculation calls it ({sub.n_frames} frames)",
         lambda: calib_camera(board, sub, seed, False, 0, False, polish_iters=2,
                              pose_init_f32=True, device="cuda")),
        (f"calib_camera as the final solve calls it, warm ({F} frames)",
         lambda: calib_camera(board, batch, model, False, 0, False, warm_poses=warm_poses,
                              warm_valid=warm_valid,
                              skip_pose_init=bool(np.all(warm_valid > 0)), device="cuda")),
        (f"calib_camera as the final solve calls it, cold ({F} frames)",
         lambda: calib_camera(board, batch, seed, False, 0, False, device="cuda")),
    ]
    result, failed = {"chunk_iters": lm.CHUNK_ITERS, "problems": []}, []
    print(f"[solver] ({card}) the LM's chunk: CHUNK_ITERS = {lm.CHUNK_ITERS} iterations per "
          "captured graph, one host read per replay")

    def measured(fn, mode):
        with solvers_eager() if mode == "eager" else contextlib.nullcontext():
            lm.reset_loop_counts()
            out, wall = sync_time(torch, fn)
            return out, wall, lm.loop_counts()

    for name, fn in problems:
        tag = f"[solver {name}] ({card})"
        entry = dict(problem=name)
        graphs.reset()
        torch.cuda.empty_cache()
        counts = []
        for i in range(2):
            graphs.reset_counts()
            out, wall, loops = measured(fn, "graphs")
            counts.append(dict(graphs.counts(), wall_s=wall, **loops))
        entry.update(first_run=counts[0], second_run=counts[1])
        print(f"{tag} first run {counts[0]['wall_s']:.3f} s: {counts[0]['captures']} captures in "
              f"{counts[0]['capture_s']:.3f} s; second run {counts[1]['wall_s']:.3f} s, captured "
              f"{counts[1]['captures']}, replayed {counts[1]['replays']}; {counts[1]['graphs']} "
              f"graphs held, pools {counts[1]['pool_mib']:.1f} MiB")
        if counts[1]["captures"] != 0:
            failed.append(f"{tag} the second run captured {counts[1]['captures']} graphs")
        runs = {"graphs": [], "eager": []}
        ref = None
        for mode in ("eager", "graphs", "graphs", "eager", "eager", "graphs"):
            out, wall, loops = measured(fn, mode)
            bits = result_bits(out)
            if ref is None:
                ref = (bits, loops["iters"])
            if not same_bits(bits, ref[0]) or loops["iters"] != ref[1]:
                failed.append(f"{tag} {mode} differs from eager (iterations {loops['iters']} "
                              f"against {ref[1]})")
            runs[mode].append(dict(wall_s=wall, **loops))
        spread = max(max(r["wall_s"] for r in rs) - min(r["wall_s"] for r in rs)
                     for rs in runs.values())
        for mode, rs in runs.items():
            with solvers_eager() if mode == "eager" else contextlib.nullcontext():
                lm.reset_loop_counts()
                prof = profile_run(torch, fn)
                loops = lm.loop_counts()
            per = max(loops["iters"], 1)
            entry[mode] = dict(
                walls_s=[r["wall_s"] for r in rs], best_s=min(r["wall_s"] for r in rs),
                iters=loops["iters"], chunks=loops["chunks"], masked=loops["masked"],
                solves=loops["solves"], launch_calls=prof["launch_calls"],
                launch_calls_per_iter=prof["launch_calls"] / per,
                device_ms_per_iter=prof["busy_s"] * 1e3 / per,
                busy=dict(busy_s=prof["busy_s"], wall_s=prof["wall_s"],
                          share=prof["busy_s"] / prof["wall_s"]))
            e = entry[mode]
            print(f"{tag} {mode}: walls {', '.join(f'{w:.4f}' for w in e['walls_s'])} s, best "
                  f"{e['best_s']:.4f} s; {e['iters']} LM iterations in {e['solves']} solves, "
                  f"{e['chunks']} host reads, {e['masked']} masked; host launch calls "
                  f"{e['launch_calls']} ({e['launch_calls_per_iter']:.1f} per iteration); card "
                  f"{e['device_ms_per_iter']:.3f} ms per iteration, busy {prof['busy_s']:.4f} s "
                  f"of {prof['wall_s']:.4f} s ({e['busy']['share']:.1%})")
        entry["spread_s"] = spread
        print(f"{tag} best graphs {entry['graphs']['best_s']:.4f} s, eager "
              f"{entry['eager']['best_s']:.4f} s, spread {spread:.4f} s; results and n_iters "
              "equal to eager bit for bit in every run")
        result["problems"].append(entry)

    # the rig's float64 joint solve, graphed, beside the rig phase's eager one
    tag = f"[solver rig {RIG['n_cams']}x{RIG['n_frames']} float64] ({card})"
    graphs.reset()
    torch.cuda.empty_cache()
    problem = rig_problem(seed=0, device="cuda", **RIG)
    rig = []
    for i in range(2):
        graphs.reset_counts()
        lm.reset_loop_counts()
        torch.cuda.reset_peak_memory_stats()
        res, wall = sync_time(torch, lambda: lm.ba_solve_multi(proj, *problem["args"]))
        rig.append(dict(graphs.counts(), wall_s=wall, peak_mib=torch.cuda.max_memory_allocated()
                        / 2**20, **lm.loop_counts()))
        if not same_bits(result_bits(res), result_bits(rig_eager["result"])):
            failed.append(f"{tag} run {i + 1} differs from the eager solve")
    lm.reset_loop_counts()
    prof = profile_run(torch, lambda: lm.ba_solve_multi(proj, *problem["args"]))
    loops = lm.loop_counts()
    rig_rec = dict(eager_s=rig_eager["seconds"], eager_iters=rig_eager["iters"], first_run=rig[0],
                   second_run=rig[1], launch_calls_per_iter=prof["launch_calls"] / loops["iters"],
                   device_ms_per_iter=prof["busy_s"] * 1e3 / loops["iters"],
                   busy_share=prof["busy_s"] / prof["wall_s"], masked=loops["masked"])
    print(f"{tag} eager (rig phase) {rig_eager['seconds']:.3f} s for {rig_eager['iters']} "
          f"iterations; graphs first run {rig[0]['wall_s']:.3f} s ({rig[0]['captures']} captures "
          f"in {rig[0]['capture_s']:.3f} s), second {rig[1]['wall_s']:.3f} s (captured "
          f"{rig[1]['captures']}), {rig[1]['iters']} iterations, {rig[1]['masked']} masked; "
          f"{rig_rec['launch_calls_per_iter']:.1f} host launch calls and "
          f"{rig_rec['device_ms_per_iter']:.3f} ms of card time per iteration, busy "
          f"{rig_rec['busy_share']:.1%}; pools {rig[1]['pool_mib']:.1f} MiB, peak "
          f"{rig[1]['peak_mib']:.0f} MiB; equal to eager bit for bit")
    if rig[1]["captures"] != 0:
        failed.append(f"{tag} the second run captured {rig[1]['captures']} graphs")
    result["rig_float64"] = rig_rec
    del problem
    graphs.reset()
    torch.cuda.empty_cache()

    # the chunk length: the 512 problem and the init attempt per K
    real_k = lm.CHUNK_ITERS
    sweep = []
    try:
        for k in SOLVER_KS:
            lm.CHUNK_ITERS = k
            for name, fn in problems[:2]:
                measured(fn, "graphs")  # captures at this K
                walls = [measured(fn, "graphs")[1] for _ in range(3)]
                lm.reset_loop_counts()
                prof = profile_run(torch, fn)
                loops = lm.loop_counts()
                rec = dict(k=k, problem=name, walls_s=walls, best_s=min(walls),
                           masked=loops["masked"], chunks=loops["chunks"],
                           device_ms_per_iter=prof["busy_s"] * 1e3 / max(loops["iters"], 1))
                sweep.append(rec)
                print(f"[solver chunk K={k}] ({card}) {name}: best {rec['best_s']:.4f} s of "
                      f"{', '.join(f'{w:.4f}' for w in walls)}; {loops['chunks']} host reads, "
                      f"{loops['masked']} masked iterations; card "
                      f"{rec['device_ms_per_iter']:.3f} ms per iteration")
    finally:
        lm.CHUNK_ITERS = real_k
    result["chunk_sweep"] = sweep
    graphs.reset()
    torch.cuda.empty_cache()

    # the 512 main path, both compositions, solver graphs against eager
    launches = 0
    decide = {}
    for comp, track in (("tracked", True), ("cold", False)):
        walls = {"graphs": [], "eager": []}
        ref = None
        # one untimed run of each first: the graphed one captures this
        # composition's shapes, so that every timed run is warm
        for mode in ("graphs", "eager", "eager", "graphs", "graphs", "eager", "eager",
                     "graphs"):
            with solvers_eager() if mode == "eager" else contextlib.nullcontext():
                with contextlib.redirect_stdout(sys.stderr):
                    r = main_path(512, N_512, frames512, board, card,
                                  f"[solver 512 {comp} main path, solver {mode}] ({card})",
                                  track=track)
            launches += r["launches"]
            bits = result_bits((r["model"], r["rtvecs"])) + [np.array([r["median"]])]
            ref = ref or bits
            if not same_bits(bits, ref):
                failed.append(f"[solver 512 {comp}] ({card}) solver {mode} changed the result")
            walls[mode].append(r["t_total"])
        warm_up = {m: v.pop(0) for m, v in walls.items()}
        spread = max(max(v) - min(v) for v in walls.values())
        gap = min(walls["graphs"]) - min(walls["eager"])
        decide[f"512 {comp} main path"] = gap > spread
        result[f"main_path_{comp}"] = dict(walls_s=walls, spread_s=spread,
                                           graphs_minus_eager_s=gap, untimed_s=warm_up)
        print(f"[solver 512 {comp} main path] ({card}) solver graphs "
              f"{', '.join(f'{w:.3f}' for w in walls['graphs'])} s, eager "
              f"{', '.join(f'{w:.3f}' for w in walls['eager'])} s (in turns, after one "
              f"untimed run each: graphs {warm_up['graphs']:.3f} s with its captures, eager "
              f"{warm_up['eager']:.3f} s); best graphs minus best eager {gap:+.3f} s, spread "
              f"{spread:.3f} s; results equal bit for bit")
    result["decide"] = decide
    print(f"[solver] ({card}) phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:  # after the measurements, so that a failed run still shows them
        raise RuntimeError("solver phase gates failed: " + "; ".join(failed))
    return result, launches


def solver_default(card, solver, fresh):
    """Print and return the default rule's verdict for calibration: graphs
    unless the 512 main path (tracked or cold) or the fresh CLI run with
    the warm-up off is slower with solver graphs than with the solvers
    eager (detection graphed in both) by more than the spread between that
    comparison's runs.  The fresh runs with everything eager are printed
    beside them, and judge nothing: they switch detection's graphs off too."""
    from ccrs_tpu_torch import graphs

    off = {m: [r["wall_s"] for r in fresh
               if r["prewarm"] == "0" and r["mode"] == m and "visible" not in r]
           for m in ("graphs", "solvers_eager", "eager")}
    spread = max(max(off[m]) - min(off[m]) for m in ("graphs", "solvers_eager"))
    gap = min(off["graphs"]) - min(off["solvers_eager"])
    decide = dict(solver["decide"], **{"fresh CLI, CCRS_PREWARM=0": gap > spread})
    slower = [k for k, v in decide.items() if v]
    rule = "eager" if slower else "graphs"
    print(f"[solver default] ({card}) fresh CLI with CCRS_PREWARM=0: graphs "
          f"{', '.join(f'{w:.3f}' for w in off['graphs'])} s, solvers eager "
          f"{', '.join(f'{w:.3f}' for w in off['solvers_eager'])} s, best graphs minus best "
          f"solvers eager {gap:+.3f} s, spread {spread:.3f} s (everything eager: "
          f"{', '.join(f'{w:.3f}' for w in off['eager'])} s)")
    print(f"[solver default] ({card}) the card runs calibration as graphs by default "
          f"(graphs.active: {graphs.active('cuda')}); this run's rule (eager if graphs are "
          f"slower than solvers eager by more than the spread on the 512 main path, tracked "
          f"or cold, or the fresh CLI run) takes {rule}" + (f": graphs slower on {slower}" if slower else ""))
    return dict(rule_takes=rule, graphs_slower_beyond_spread=slower,
                fresh=dict(walls_s=off, spread_s=spread, graphs_minus_solvers_eager_s=gap))


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
    frames1024, scale, launches1024, _ = run_phase(1024, N_1024, card)
    k1024 = check_kernel(frames1024, scale, card, f"{N_1024}x1024x1024")
    ccl.append(run_ccl_phase(card, frames1024[: N_CCL[1024]].contiguous(), scale, "1024 phase"))
    cli_frames, launches_cli, joint, fresh = run_cli_phase(card)
    if launches_cli <= 0:
        raise RuntimeError("the CLI run never launched the threshold kernel")
    launches_fresh = sum(r["launches"] for r in fresh)
    launches_prewarm = sum(r["launches_prewarm"] for r in fresh)
    if launches_fresh <= 0 or launches_prewarm <= 0:
        raise RuntimeError("the fresh-process CLI runs never launched the threshold kernel")
    from ccrs_tpu_torch.board import create_default_6x6_board

    mesh_phase, launches_mesh = run_mesh_phase(card, frames512, run512,
                                               create_default_6x6_board(), joint)
    rig, rig_eager = run_rig_phase(card, run512, create_default_6x6_board())
    solver, launches_solver = run_solver_phase(card, frames512, run512,
                                               create_default_6x6_board(), rig_eager)
    del rig_eager
    solver["default"] = solver_default(card, solver, fresh)
    pipeline, launches_pipeline = run_pipeline_phase(card, frames512, cli_frames,
                                                     create_default_6x6_board())
    from ccrs_tpu_torch.detect import graphs

    with graphs.eager():  # the comparison of the two branches, eagerly
        sampling, launches_sampling = run_sampling_phase(card, frames512, frames1024,
                                                         cli_frames, create_default_6x6_board())
    graphs_phase, launches_graphs = run_graphs_phase(card, frames512, frames1024, cli_frames,
                                                     create_default_6x6_board())
    del frames512, frames1024
    run_undistort_phase(card, cli_frames[0][0])
    launches_colour = run_colour_phase(card, cli_frames[0][:N_COLOUR])
    run_tools_phase(card)
    graphs.reset()  # the timing programs' processes need the card's memory
    torch.cuda.empty_cache()
    bench, launches_bench = run_bench_phase(card)
    # every decoded frame of both cameras, as one sequence of 2 x 640 frames
    kcli = check_kernel(torch.as_tensor(np.concatenate(cli_frames)).cuda(), 1, card,
                        f"2 cameras x {N_CLI}x480x752")
    torch.cuda.synchronize()
    shapes = [k512, k1024, kcli]

    print(json.dumps({"ccl": ccl, "card": card}))
    print(json.dumps({"fresh": fresh, "rig": rig, "card": card}))
    print(json.dumps({"bench": bench, "card": card}))
    print(json.dumps({"pipeline": pipeline, "card": card}))
    print(json.dumps({"sampling": sampling, "card": card}))
    print(json.dumps({"graphs": graphs_phase, "card": card}))
    print(json.dumps({"solver": solver, "card": card}))
    print(json.dumps({"mesh": mesh_phase, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "threshold_front",
        "route": "cuda",
        "source": "ccrs_tpu_torch/csrc/threshold.cu",
        "replaces": "ccrs_tpu/ops/threshold_pallas.py:35",
        "launches": (launches512 + launches1024 + launches_cli + launches_mesh
                     + launches_pipeline + launches_sampling + launches_graphs
                     + launches_solver + launches_colour + launches_fresh + launches_bench),
        "launches_512": launches512,
        "launches_1024": launches1024,
        "launches_cli": launches_cli,
        "launches_mesh": launches_mesh,
        # the pipeline phase's pipelined cold detections (warm runs included)
        "launches_pipeline": launches_pipeline,
        # the sampling phase's detections, both branches
        "launches_sampling": launches_sampling,
        # the graphs phase's detections, with graphs and eager
        "launches_graphs": launches_graphs,
        # the solver phase's 512 main paths, solver graphs and eager
        "launches_solver": launches_solver,
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
