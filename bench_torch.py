#!/usr/bin/env python
"""End-to-end detect+calibrate throughput of the PyTorch/CUDA port
(``ccrs_tpu_torch``): the counterpart of ``bench.py``, step for step.

Measures the full pipeline (batched AprilGrid detection -> init -> LM
bundle adjustment -> validation) on TUM-VI-like synthetic video (EUCM
fisheye, default 6x6 board, rendered on the device with noise) at two
resolutions:

- 512x512 -- the TUM-VI 512 regime; its fps is the headline ``value``;
- 1024x1024 -- the intrinsics scaled by 2, the pyramid branch of the
  threshold kernel (``fps_1024``).

Each resolution renders its frames while two threads pay the process's
one-time costs (``TagDetector.prewarm`` and ``prewarm_calibration``), runs
the default composition once (``warmup_sec``, with stage totals), then
best of 5 (512) or 3 (1024) timed runs.  The 512 configuration also runs
the same frames from host memory through a streaming ``TrackedSession``
(``fps_host``, ``upload_sec``, ``fps_host_bound``) and through the CLI on an
on-disk EuRoC-layout dataset (``fps_cli``).

Gates (the run fails on any): focal within 1%, median reprojection below
0.3 px, a float64 re-solve on the CPU at the same RMS within 1e-6 px,
speculation offered at 512 (unless ``BENCH_NO_SPEC_ASSERT=1``), and the
CLI's focal and median.  Nothing falls back: a failed device render or
device-resident detection raises.  On the card the threshold kernel's
launches over the whole run are printed to stderr, and the run fails if
there were none.

Knobs (``bench.py``'s, no others): ``BENCH_FRAMES`` (534),
``BENCH_FRAMES_1024`` (128), ``BENCH_HOST_IMAGES=1`` (host-rendered frames
from ``testdata.render_board_image``), ``BENCH_NO_SPEC_ASSERT``,
``BENCH_SKIP_F64GATE``, ``BENCH_SKIP_HOST``, ``BENCH_SKIP_CLI``,
``BENCH_SKIP_1024``, ``CCRS_TIMING_SPANS``.

Usage: ``python3 bench_torch.py [--platform cuda|cpu]`` (default ``cuda``;
without a card it exits non-zero unless the CPU is asked for).  Progress
goes to stderr; the last line of stdout is one JSON object with
``bench.py``'s keys plus ``device`` (the card's name and power limit, or
``"cpu"``).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ccrs_tpu_torch import cli as cli_mod
from ccrs_tpu_torch import graphs
from ccrs_tpu_torch.board import BoardConfig, create_default_6x6_board
from ccrs_tpu_torch.calib import calib_camera, validation
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
from ccrs_tpu_torch.calib.prewarm import prewarm_calibration
from ccrs_tpu_torch.calib.validate import reprojection_errors
from ccrs_tpu_torch.dataloader import DETECT_BATCH
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.io import object_to_json
from ccrs_tpu_torch.models import GenericModel, model_from_json, zeros_like_model
from ccrs_tpu_torch.pngio import write_png
from ccrs_tpu_torch.testdata import (
    render_board_image,
    render_frames_device,
    smooth_sequence_poses,
)
from ccrs_tpu_torch.types import CalibParams
from ccrs_tpu_torch.utils import profiling

# the full north-star length (534-frame TUM-VI calib-cam1 regime);
# BENCH_FRAMES=48 for quick iteration
N_FRAMES = int(os.environ.get("BENCH_FRAMES", "534"))
N_FRAMES_1024 = int(os.environ.get("BENCH_FRAMES_1024", "128"))
NORTH_STAR_FPS = 534 / 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[device.index or 0]


def run_config(size: int, n_frames: int, collect_stages: bool, device="cuda"):
    """One resolution: returns (fps, warm-up seconds, stage totals of the
    best timed run, extra keys of the JSON line)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            # waits for any capture on another thread to end first (a
            # device-wide synchronize fails while a stream captures)
            graphs.synchronize(device)

    board = create_default_6x6_board()
    fam = get_family("t36h11")
    s = size / 512.0
    gt = GenericModel(
        "eucm",
        [190.9 * s, 190.87 * s, 254.94 * s, 256.86 * s, 0.628, 1.046],
        size, size,
    )

    log(f"[{size}] rendering {n_frames} frames...")
    t_start = time.perf_counter()
    detector = TagDetector("t36h11", device=device)
    poses = smooth_sequence_poses(n_frames, board, seed=11)
    imgs, dev_imgs = None, None
    # the detect path's and the calibration's one-time costs on two threads
    # beside the render; leaving the block joins both, and a failure on
    # either raises below
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        warm_jobs = [
            pool.submit(detector.prewarm, size, size, board, n_frames=n_frames),
            pool.submit(
                prewarm_calibration, board, n_frames, "eucm", CalibParams(),
                size, size, speculative=True, device=device,
            ),
        ]
        if os.environ.get("BENCH_HOST_IMAGES", "") != "1":
            # device-resident frames, rendered on the device
            dev_imgs = render_frames_device(
                gt, board, fam, poses, noise=1.5,
                generator=torch.Generator(device=device).manual_seed(11), device=device,
            )
            sync()
        else:
            imgs = np.stack([
                render_board_image(gt, board, fam, p[:3], p[3:], noise=1.5, seed=f)
                for f, p in enumerate(poses)
            ])
        t_render = time.perf_counter()
    for job in warm_jobs:
        job.result()
    log(
        f"[{size}] render+prewarm: render done +{t_render - t_start:.1f}s, "
        f"prewarm joined +{time.perf_counter() - t_start:.1f}s"
    )
    times = list(range(n_frames))

    def pipeline(seed):
        # each run is an independent dataset pass: drop the video carry
        detector.reset_tracking()
        gen = torch.Generator(device=device).manual_seed(seed)
        # speculative calibration overlaps the detector's audit sweeps;
        # the final solve warm-starts from it but still runs to full
        # convergence on the final detections (gated identically)
        spec = SpeculativeCalib(
            board, times, zeros_like_model("eucm"), CalibParams(), gen, size, size,
        )
        detector.on_provisional = spec.on_provisional
        dets = detector.detect_batch(imgs, board=board, dev_images=dev_imgs)
        batch = FrameBatch.from_detections(dets, times, board, size, size)
        # the product retry ladder (random frame re-pick on failure), as the CLI
        result = calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(), gen,
            warm_provider=spec.take, device=device,
        )
        sync()
        return batch, result

    # warm-up: the first run pays what the prewarm threads did not.
    # Stage-attributed: warm-up minus timed-run stage time = first-call cost
    log(f"[{size}] warmup run...")
    if collect_stages:
        profiling.enable()
        profiling.reset()
    t0 = time.perf_counter()
    batch, (model, rtvecs) = pipeline(0)
    warm = time.perf_counter() - t0
    log(f"[{size}] warmup: {warm:.1f}s")
    if collect_stages:
        wstages = profiling.totals()
        for name in sorted(wstages, key=lambda k: -wstages[k]):
            log(f"  warmup stage {name:24s} {wstages[name]:7.3f}s")

    # timed runs: best of 5 (host times spread between runs)
    elapsed = float("inf")
    stages = {}
    for rep in range(5 if collect_stages else 3):
        profiling.reset()
        t0 = time.perf_counter()
        batch, (model, rtvecs) = pipeline(1)
        dt = time.perf_counter() - t0
        log(f"[{size}] timed run {rep}: {dt:.2f}s")
        if dt < elapsed:
            elapsed = dt
            stages = profiling.totals()
    if os.environ.get("CCRS_TIMING_SPANS"):
        # span timeline of the LAST rep: the critical path through the
        # overlapped stages
        sp = profiling.spans()
        if sp:
            t_base = min(s[2] for s in sp)
            for name, thr, a, b in sorted(sp, key=lambda s: s[2]):
                log(f"  span {a - t_base:7.3f} -> {b - t_base:7.3f} ({b - a:6.3f}s) {name} [{thr}]")
    profiling.reset()
    for name in sorted(stages, key=lambda k: -stages[k]):
        log(f"  stage {name:24s} {stages[name]:7.3f}s")
    if detector.stats:
        log(f"  detector stats: {detector.stats}")

    # speculation observability: a silent regression must fail the bench
    spec_offered = bool(calibrate_camera_with_retries.last_warm_offered)
    spec_used = bool(calibrate_camera_with_retries.last_spec_used)
    log(f"[{size}] speculation: offered={spec_offered} used={spec_used}")
    if collect_stages and os.environ.get("BENCH_NO_SPEC_ASSERT", "") != "1":
        check(spec_offered, "speculation never produced a warm seed")

    # correctness gate
    with contextlib.redirect_stdout(sys.stderr):
        _, median = validation(board, batch, model, rtvecs)
    focal_err = abs(model.params[0] - gt.params[0]) / gt.params[0]
    check(focal_err < 0.01, f"[{size}] focal off by {focal_err:.2%}")
    check(median < 0.3, f"[{size}] median reprojection {median:.3f} px")
    log(f"[{size}] gate ok: focal err {focal_err:.2%}, median {median:.4f} px")

    # interchange-precision gate: the final BA re-run on the CPU in float64
    # must land on the same RMS within 1e-6 px
    if collect_stages and os.environ.get("BENCH_SKIP_F64GATE", "") != "1":

        def rms_of(m, rt):
            errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, m, rt)])
            return float(np.sqrt(np.mean(errs**2)))

        rms_dev = rms_of(model, rtvecs)
        cpu_res = calib_camera(
            board, batch, model, xy_same_focal=False, disabled_distortions=0,
            fixed_focal=False, device="cpu",
        )
        check(cpu_res is not None, f"[{size}] host f64 re-solve failed")
        drift = abs(rms_dev - rms_of(*cpu_res))
        check(drift < 1e-6, f"[{size}] f64 interchange drift {drift:.2e} px")
        log(f"[{size}] f64 gate ok: |rms_dev - rms_cpu| = {drift:.2e} px")

    # the same frames fed from host memory: one synchronous upload of the
    # whole batch timed alone (upload_sec), then the product composition
    # for host frames, chunked uploads into one streaming TrackedSession
    fps_host = None
    upload_sec = None
    if collect_stages and dev_imgs is not None and os.environ.get("BENCH_SKIP_HOST", "") != "1":
        host_imgs = dev_imgs.cpu()
        if device.type == "cuda":
            host_imgs = host_imgs.pin_memory()
        sync()
        t0 = time.perf_counter()
        up = host_imgs.to(device, non_blocking=True, copy=True)
        sync()
        upload_sec = time.perf_counter() - t0
        del up
        mb = host_imgs.numel() / 1e6
        log(f"[{size}] host->device upload: {upload_sec:.4f}s for {mb:.0f} MB "
            f"({mb / upload_sec:.0f} MB/s)")
        host_np = host_imgs.numpy()

        def upload(chunk):
            host = torch.from_numpy(chunk)
            if device.type != "cuda":
                return host.to(device, copy=True)
            return host.pin_memory().to(device, non_blocking=True)

        def pipeline_host(seed):
            detector.reset_tracking()
            gen = torch.Generator(device=device).manual_seed(seed)
            spec = SpeculativeCalib(
                board, times, zeros_like_model("eucm"), CalibParams(), gen, size, size,
            )
            detector.on_provisional = spec.on_provisional
            # n_frames hint: the preallocated-buffer placement the CLI
            # loader drives
            session = detector.begin_tracked(board, n_frames=n_frames)
            devs, sizes = [], []
            for off in range(0, n_frames, DETECT_BATCH):
                chunk = host_np[off : off + DETECT_BATCH]
                nv = chunk.shape[0]
                if nv < DETECT_BATCH and n_frames > DETECT_BATCH:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], DETECT_BATCH - nv, 0)])
                devs.append(upload(chunk))  # async enqueue on the card
                sizes.append(nv)
            for d, nv in zip(devs, sizes):
                session.feed(d, n_valid=nv)
            dets = session.finalize()
            batch = FrameBatch.from_detections(dets, times, board, size, size)
            result = calibrate_camera_with_retries(
                board, batch, zeros_like_model("eucm"), CalibParams(), gen,
                warm_provider=spec.take, device=device,
            )
            sync()
            return batch, result

        pipeline_host(0)  # warm any host-path-only first calls
        best = float("inf")
        for rep in range(2):
            t0 = time.perf_counter()
            pipeline_host(1)
            dt = time.perf_counter() - t0
            log(f"[{size}] host-image run {rep}: {dt:.2f}s")
            best = min(best, dt)
        fps_host = n_frames / best

    # the CLI entry point end to end on an on-disk EuRoC-layout dataset of
    # the same frames, with the same gates on its own artifacts: it pays
    # PNG decode, the upload, the streaming session and artifact writing
    fps_cli = None
    spec_used_cli = None
    if collect_stages and dev_imgs is not None and os.environ.get("BENCH_SKIP_CLI", "") != "1":
        with tempfile.TemporaryDirectory(prefix="ccrs_bench_cli_") as tmpd:
            ddir = os.path.join(tmpd, "dataset", "mav0", "cam0", "data")
            os.makedirs(ddir)
            frames_u8 = dev_imgs.cpu().numpy()
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as pool:
                list(pool.map(
                    lambda i: write_png(
                        os.path.join(ddir, f"{10_000_000_000 + i * 100_000_000}.png"),
                        frames_u8[i],
                    ),
                    range(n_frames),
                ))
            log(f"[{size}] cli dataset written in {time.perf_counter() - t0:.1f}s")

            # the board config inside the temporary directory (the CLI would
            # otherwise write default_board_config.json into the cwd)
            bcfg_path = os.path.join(tmpd, "board_config.json")
            object_to_json(bcfg_path, BoardConfig().to_json())

            def run_cli(tag, prewarm=False):
                # the timed in-process runs skip the warm-up thread: this
                # process is warm by now
                prev = os.environ.get("CCRS_PREWARM")
                os.environ["CCRS_PREWARM"] = "1" if prewarm else "0"
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(sys.stderr):
                        cli_mod.main([
                            os.path.join(tmpd, "dataset"),
                            "--model", "eucm",
                            "--board-config", bcfg_path,
                            "--output-folder", os.path.join(tmpd, tag),
                            "--no-rerun",
                            "--seed", "11",
                            "--platform", "cuda" if device.type == "cuda" else "cpu",
                        ])
                finally:
                    if prev is None:
                        os.environ.pop("CCRS_PREWARM", None)
                    else:
                        os.environ["CCRS_PREWARM"] = prev
                return time.perf_counter() - t0

            dt = run_cli("warm", prewarm=True)
            log(f"[{size}] cli warmup run: {dt:.2f}s")
            best_cli = float("inf")
            for rep in range(2):
                dt = run_cli(f"timed{rep}")
                log(f"[{size}] cli run {rep}: {dt:.2f}s")
                best_cli = min(best_cli, dt)
            fps_cli = n_frames / best_cli
            spec_used_cli = bool(calibrate_camera_with_retries.last_spec_used)
            # the same gates, on the CLI's own artifacts
            fx = model_from_json(os.path.join(tmpd, "timed1", "cam0.json")).params[0]
            cli_focal_err = abs(fx - gt.params[0]) / gt.params[0]
            check(cli_focal_err < 0.01, f"[cli] focal off {cli_focal_err:.2%}")
            with open(os.path.join(tmpd, "timed1", "report.txt")) as f:
                rep_txt = f.read()
            cli_med = float(rep_txt.split("median  reprojection error:")[1].split("px")[0])
            check(cli_med < 0.3, f"[cli] median reprojection {cli_med:.3f} px")
            log(f"[{size}] cli gate ok: focal err {cli_focal_err:.2%}, "
                f"median {cli_med:.4f} px, spec_used={spec_used_cli}")

    extras = {}
    if fps_host is not None:
        extras["fps_host"] = round(fps_host, 2)
    if upload_sec is not None:
        # a separately measured synchronous whole-batch upload, which no
        # timed run performs: its own key, never part of the stage totals
        extras["upload_sec"] = round(upload_sec, 3)
        # the host-image path's ceiling if uploads never overlapped work
        extras["fps_host_bound"] = round(n_frames / upload_sec, 2)
    if fps_cli is not None:
        extras["fps_cli"] = round(fps_cli, 2)
        extras["spec_used_cli"] = spec_used_cli
    if collect_stages:
        extras["spec_offered"] = spec_offered
        extras["spec_used"] = spec_used
    return n_frames / elapsed, warm, stages, extras


def run(device="cuda") -> dict:
    fps_512, warm, stages, extras = run_config(512, N_FRAMES, collect_stages=True, device=device)
    fps_1024 = warm_1024 = None
    if os.environ.get("BENCH_SKIP_1024", "") != "1":
        fps_1024, warm_1024, _, _ = run_config(
            1024, N_FRAMES_1024, collect_stages=False, device=device
        )
    value = round(fps_512, 2)
    out = {
        "metric": "end-to-end detect+calibrate throughput (512x512 EUCM AprilGrid, TUM-VI-like synthetic video, %d frames)" % N_FRAMES,
        "value": value,
        "unit": "frames/sec",
        # value / 267 fps, of the value as printed (not of the unrounded rate)
        "vs_baseline": round(value / NORTH_STAR_FPS, 4),
        "warmup_sec": round(warm, 1),
        "stages_sec": {k: round(v, 3) for k, v in sorted(stages.items())},
    }
    out.update(extras)
    if fps_1024 is not None:
        out["fps_1024"] = round(fps_1024, 2)
        out["warmup_1024"] = round(warm_1024, 1)
    out["device"] = device_label(torch.device(device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--platform", default="cuda", choices=["cuda", "cpu"],
        help="where the pipeline runs (default cuda; without a card the run "
        "exits non-zero unless cpu is asked for)",
    )
    args = ap.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: --platform cuda but no CUDA device is available")
    device = torch.device("cuda", torch.cuda.current_device()) if args.platform == "cuda" \
        else torch.device("cpu")
    result = run(device)
    if device.type == "cuda":
        from ccrs_tpu_torch.ops.threshold_cuda import kernel_launches

        launches = kernel_launches()
        log(f"threshold kernel launches over the run: {launches}")
        check(launches > 0, "the run never launched the threshold kernel")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
