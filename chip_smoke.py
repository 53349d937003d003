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
  --step 4``, 160 frames per camera).

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
cameras) and both are timed; every main-path run (and each CLI run) must
launch it.

Usage: ``python3 chip_smoke.py`` from the repository root (builds the CUDA
kernel, the host quad extractor and the PNG unfilter routine into
``ccrs_tpu_torch/_build/``; the cli phase's dataset lives in a temporary
directory that is removed at the end).
Prints stage times, detector stats and gates per run, a JSON line of
kernel results, then as its last line ``{"ok": true, "device": {...}}``.
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
    return frames, 2 if size >= PYRAMID_MIN_SIDE else 1, sum(launches)


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
    the run."""
    from ccrs_tpu_torch import cli
    from ccrs_tpu_torch.calib.multi import calib_all_camera_with_extrinsics
    from ccrs_tpu_torch.calib.validate import reprojection_errors
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
        with env_set(**env), observe_joint_solve(cli) as seen, \
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
    board, _, _, rt_in, batches = seen["args"][:5]
    models, t_i_0, board_rt = seen["result"]
    usable = [float(b.frame_ok().mean()) for b in batches]
    print(f"{label} usable frames (>= 24 corners): {usable}")
    if not min(usable) >= 0.8:
        raise RuntimeError(f"{label} too few usable frames: {usable}")

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
        raise RuntimeError(f"{label} CPU float64 joint re-solve failed")
    rms_card, rms_cpu = rms(models, t_i_0, board_rt), rms(*cpu)
    drift = max(abs(a - b) for a, b in zip(rms_card, rms_cpu))
    print(
        f"{label} CPU float64 joint re-solve: rms card {rms_card} px, "
        f"|rms_card - rms_cpu| = {drift:.3e} px ({time.perf_counter() - t1:.1f} s)"
    )
    if not (drift < 1e-6):
        raise RuntimeError(f"{label} float64 interchange drift {drift:.3e} px")
    return launches


def run_cli_phase(card):
    """Render + write the stereo dataset, then run the CLI on it twice: the
    default composition (tracked detection, speculative calibration) on
    every frame, and the cold composition (CCRS_TRACK=0, --no-speculate)
    on every 4th frame.  Returns (decoded frames per camera, threshold
    launches of both CLI runs)."""
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
        launches = run_cli(
            tmp, "out", ds, gt, rig, f"[cli 2x{N_CLI}x752x480] ({card})", [], {}
        )
        launches += run_cli(
            tmp, "out_cold", ds, gt, rig, f"[cli cold 2x{N_CLI // 4}x752x480] ({card})",
            ["--no-speculate", "--step", "4"], {"CCRS_TRACK": "0"},
        )
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
        "launches_512": launches512,
        "launches_1024": launches1024,
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
