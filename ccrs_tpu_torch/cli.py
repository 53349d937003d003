"""ccrs-compatible command-line interface of the PyTorch port.

Port of ``ccrs_tpu/cli.py``: the same positional dataset path, flags,
defaults, printed lines and artifact set (``default_board_config.json`` in
the working directory; ``cam{i}.json``, ``cam{i}_poses.json``,
``extrinsics.json`` and ``report.txt`` under the output folder, plus
``camchain.yaml`` with ``--export-camchain`` and ``logging.rrd`` when
``rerun`` is installed).  The default composition is the JAX package's:
wave-tracked detection (``CCRS_TRACK=0`` detects every frame cold) and
speculative calibration, which solves on the tracker's provisional
detections while its audits run and warm-starts each camera's retry
ladder (``--no-speculate`` or ``CCRS_SPECULATE=0`` turn it off; results
are the same either way).  Even a one-camera run ends in the joint
multi-camera solve, as in the reference.  With ``CCRS_PREWARM=1`` a
background thread, started at the first decoded image, pays the process's
one-time costs on dummy data (``Prewarm``; it changes timing only, and is
off by default because on an H100 it measured slower than paying them in
the first solve).

Run as ``python -m ccrs_tpu_torch <dataset> --model eucm ...``.
Detection, calibration and the joint solve run on the current CUDA device
(``--platform cuda``, the default) and never fall back to the CPU: without
a card the run exits with an error.  ``--platform auto`` is kept for flag
parity with the JAX CLI and also means the card; only ``--platform cpu``
runs on the CPU.

Randomness: the JAX package splits one PRNG key per camera from
``--seed``.  The port derives the cameras' streams up front from
``numpy.random.SeedSequence(--seed).spawn(cam_num)``; camera i's RANSAC and
retry draws come from a ``torch.Generator`` on the solve's device seeded
with the first word of its child sequence.  A camera's speculative solve
starts from a copy of that generator's state.  The draws differ from the
JAX package's; the calibrated optimum does not depend on which valid
hypothesis seeded it.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import threading
import time
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch

from .board import Board, BoardConfig
from .calib import validation
from .calib.frames import FrameBatch
from .calib.multi import calib_all_camera_with_extrinsics, init_camera_extrinsic
from .calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
from .calib.prewarm import prewarm_calibration
from .dataloader import DETECT_BATCH, load_euroc, load_general
from .detect import FAMILY_NAMES, TagDetector
from .io import object_from_json, object_to_json, write_report
from .models import MODEL_NAMES, model_to_json, zeros_like_model
from .types import CalibParams, Extrinsics, RvecTvec
from .utils.profiling import stage, stage_prefix, with_profiler
from .visualization import Recorder

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccrs",
        description="camera intrinsic calibration from AprilGrid images "
        "(PyTorch; detection and solves on a CUDA GPU)",
    )
    p.add_argument("path", help="path to image folder")
    # t25h7 is accepted for reference-CLI parity but requires a
    # user-supplied code table (families.family_from_table docstring)
    p.add_argument(
        "--tag-family", default="t36h11", choices=FAMILY_NAMES + ["t25h7"]
    )
    p.add_argument(
        "--tag-family-table",
        default=None,
        metavar="NPZ",
        help="custom code table for the tag family (required for t25h7, "
        "whose canonical table cannot be regenerated offline; keys: codes "
        "[+ size/border/max_hamming])",
    )
    p.add_argument("-m", "--model", default="eucm", choices=list(MODEL_NAMES))
    p.add_argument("--start-idx", type=int, default=0)
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--max-images", type=int, default=600)
    p.add_argument("--cam-num", type=int, default=1)
    p.add_argument("--board-config", default=None)
    p.add_argument("-o", "--output-folder", default=None)
    p.add_argument("--dataset-format", default="euroc", choices=["euroc", "general"])
    p.add_argument("--one-focal", action="store_true")
    p.add_argument("--disabled-distortion-num", type=int, default=0)
    p.add_argument("--fixed-focal", type=float, default=None)
    p.add_argument("--seed", type=int, default=0, help="PRNG seed (RANSAC/retries)")
    p.add_argument("--no-rerun", action="store_true", help="skip .rrd logging")
    p.add_argument(
        "--export-camchain",
        action="store_true",
        help="also write a Kalibr camchain.yaml (eucm/ucm/kb4/opencv5)",
    )
    p.add_argument(
        "--detection-cache",
        default=None,
        metavar="DIR",
        help="cache detections under DIR (keyed by file list/mtimes) so "
        "re-runs skip re-detection",
    )
    p.add_argument(
        "--platform",
        default="cuda",
        choices=["auto", "cpu", "cuda"],
        help="device to run on (default cuda: the current CUDA device; auto "
        "means the same; without a device both exit with an error; only cpu "
        "runs on the CPU)",
    )
    p.add_argument(
        "--no-speculate",
        action="store_true",
        help="disable speculative calibration (the solve that overlaps "
        "detection audits; results are identical either way, speculation "
        "only changes timing — CCRS_SPECULATE=0 is equivalent)",
    )
    return p


def resolve_device(platform: str) -> torch.device:
    """The device ``--platform`` names: the CPU only for ``cpu``; ``cuda``
    and ``auto`` mean the current CUDA device and exit without one (never a
    silent CPU fallback)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"--platform {platform}: no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def setup_board(args) -> Board:
    if args.board_config:
        return Board.from_config(BoardConfig.from_json(object_from_json(args.board_config)))
    config = BoardConfig()
    object_to_json("default_board_config.json", config.to_json())
    return Board.from_config(config)


def setup_output_folder(args) -> str:
    folder = args.output_folder or datetime.now().strftime("results/%Y%m%d_%H_%M_%S")
    os.makedirs(folder, exist_ok=True)
    return folder


def _cam_calib_params(args, cam_idx: int) -> CalibParams:
    """Per-camera CalibParams; --fixed-focal applies to cam0 only
    (``src/bin/camera_calibration.rs:218``)."""
    return CalibParams(
        fixed_focal=args.fixed_focal if cam_idx == 0 else None,
        disabled_distortion_num=args.disabled_distortion_num,
        one_focal=args.one_focal,
    )


def camera_generators(seed: int, cam_num: int, device) -> List[torch.Generator]:
    """One ``torch.Generator`` per camera on ``device``, derived up front
    from ``seed`` (see the module docstring)."""
    children = np.random.SeedSequence(seed).spawn(max(cam_num, 1))
    return [
        torch.Generator(device=device).manual_seed(int(c.generate_state(1)[0]))
        for c in children
    ]


class Prewarm:
    """The loaders' ``prewarm_cb``: on the thread the loader starts at the
    first decoded image, run ``detector.prewarm`` and
    ``prewarm_calibration`` on dummy data of the run's frame size, model
    and parameters, so that library loads, first launches and the first
    ``torch.func`` solve overlap image decoding and detection instead of
    stalling the first chunk and the first (speculative) solve.

    ``CCRS_PREWARM=1`` opts in; unset or ``0`` the callback does nothing.
    The JAX package warms by default because its set-up is compilation,
    which runs beside the host's decoding.  Here the one-time cost is host
    work under the interpreter lock, as detection is, so the thread has
    nothing idle to use: fresh CLI runs on an H100 were slower with it on
    (``tools/fresh_cli_probe.py``).  A failure does not end the run: it is
    logged and kept in ``error`` (its repr; ``SpeculativeCalib.error``'s
    convention), which ``main`` prints.  ``join`` waits for the thread, so no device work is
    left running when the process exits.
    """

    def __init__(self, args, detector, board, device, speculative: bool):
        self._args = (args, detector, board, device, speculative)
        self._thread = None
        self.error = None
        self.seconds = None

    def __call__(self, width: int, height: int, n_frames: int) -> None:
        if os.environ.get("CCRS_PREWARM", "0") == "0":
            return
        self._thread = threading.current_thread()
        args, detector, board, device, speculative = self._args
        t0 = time.perf_counter()
        try:
            # the loader streams DETECT_BATCH-frame chunks and the tracked
            # session detects the padded sequence at once: the frame count
            # the JAX warm-up sizes its graphs by
            if n_frames > DETECT_BATCH:
                n_detect = -(-n_frames // DETECT_BATCH) * DETECT_BATCH
            else:
                n_detect = n_frames
            with stage_prefix("prewarm/"):
                with stage("detect"):
                    detector.prewarm(height, width, board, n_frames=n_detect)
                with stage("calib"):
                    prewarm_calibration(
                        board, min(n_frames, args.max_images), args.model,
                        _cam_calib_params(args, 0), width, height,
                        speculative=speculative, n_frames_spec=n_frames,
                        device=device,
                    )
        except Exception as e:  # the run goes on; the error stays visible
            log.exception("prewarm failed (continuing; the first solve pays the costs)")
            self.error = repr(e)
        self.seconds = time.perf_counter() - t0

    def join(self) -> None:
        """Wait for the warm-up thread, if the loader started one."""
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join()


def load_feature_data(args, detector, board, recorder, specs=None,
                      generators=None, prewarm_cb=None) -> List[FrameBatch]:
    """Detect features for every camera.

    ``specs`` / ``generators``: optional dict + per-camera generators that
    enable SPECULATIVE calibration — a SpeculativeCalib per camera is
    registered on the detector, so its solve overlaps the detection
    audits, and stored in ``specs[cam_idx]`` for ``calibrate_all_cameras``.
    ``prewarm_cb``: handed to the loader (``Prewarm``).
    """
    print("Start loading images and detecting charts.")
    t0 = time.perf_counter()
    loader = load_euroc if args.dataset_format == "euroc" else load_general
    spec_factory = None
    if specs is not None:
        def spec_factory(cam_idx, times, width, height):
            spec = SpeculativeCalib(
                board, times, zeros_like_model(args.model),
                _cam_calib_params(args, cam_idx), generators[cam_idx],
                width, height,
            )
            specs[cam_idx] = spec
            return spec.on_provisional

    batches = loader(
        args.path, detector, board, args.start_idx, args.step, args.cam_num,
        recorder, cache_dir=args.detection_cache, prewarm_cb=prewarm_cb,
        spec_factory=spec_factory,
    )
    dt = time.perf_counter() - t0
    print(f"detecting feature took {dt:.6f} sec")
    if batches and batches[0].n_frames:
        print(f"total: {batches[0].n_frames} images")
        print(f"avg: {dt / batches[0].n_frames} sec")
    for cam_idx, b in enumerate(batches):
        if b.n_frames == 0:
            raise SystemExit(
                f"no images found for cam{cam_idx} under {args.path!r} "
                f"(dataset format: {args.dataset_format})"
            )
        if not b.frame_ok().any():
            raise SystemExit(
                f"no frame of cam{cam_idx} has >= 24 detected corners; "
                "check --tag-family and --board-config"
            )
    return [b.truncate(args.max_images) for b in batches]


def _warm_adapter(spec, batch):
    """Wrap SpeculativeCalib.take for a batch that may have been TRUNCATED
    after detection (--max-images, as the reference truncates after
    detecting, ``src/bin/camera_calibration.rs:190-191``): clip the warm
    pose rows to the batch length."""
    if spec is None:
        return None

    def provider():
        warm = spec.take()
        if warm is None:
            return None
        model, poses, valid, init_frames = warm
        F = batch.n_frames
        if len(poses) < F:
            return None
        return (model, poses[:F], valid[:F], init_frames)

    return provider


def calibrate_all_cameras(args, board, batches, recorder, generators, device,
                          specs=None):
    intrinsics, cam_rtvecs = [], []
    for cam_idx, batch in enumerate(batches):
        warm_provider = _warm_adapter((specs or {}).get(cam_idx), batch)
        try:
            with stage(f"cam{cam_idx}/calibrate"):
                model, rtvecs = calibrate_camera_with_retries(
                    board, batch, zeros_like_model(args.model),
                    _cam_calib_params(args, cam_idx), generators[cam_idx],
                    seed=args.seed + cam_idx, warm_provider=warm_provider,
                    device=device,
                )
        except RuntimeError as e:
            raise SystemExit(f"cam{cam_idx}: {e}")
        init_frames = calibrate_camera_with_retries.last_init_frames
        if init_frames is not None:
            # /cam{i}/keyframe{j} markers for the two init frames
            # (src/util.rs:898-908); a warm start's init frames can sit
            # past a --max-images truncation: those markers are skipped
            recorder.log_keyframes(
                cam_idx,
                [int(batch.time_ns[f]) for f in init_frames if 0 <= f < batch.n_frames],
            )
        intrinsics.append(model)
        cam_rtvecs.append(rtvecs)
    return intrinsics, cam_rtvecs


def _write_camchain(args, output_folder, models, t_i_0=None):
    if not args.export_camchain:
        return
    from .export import write_camchain

    try:
        write_camchain(f"{output_folder}/camchain.yaml", models, t_i_0)
        print(f"wrote {output_folder}/camchain.yaml")
    except ValueError as e:
        print(f"camchain export skipped: {e}")


def save_and_validate_results(
    args, output_folder, board, batches, intrinsics, cam_rtvecs, t_cam_i_0,
    recorder, device="cuda",
):
    with stage("joint_ba"):
        joint = calib_all_camera_with_extrinsics(
            board,
            intrinsics,
            t_cam_i_0,
            cam_rtvecs,
            batches,
            xy_same_focal=args.one_focal or args.fixed_focal is not None,
            disabled_distortions=args.disabled_distortion_num,
            cam0_fixed_focal=args.fixed_focal is not None,
            device=device,
        )
    rep_rms = []
    if joint is not None:
        cam_models, t_i_0, board_rtvecs = joint
        for cam_idx, model in enumerate(cam_models):
            new_rtvecs: Dict[int, RvecTvec] = {
                f: t_i_0[cam_idx].compose(t_0_b) for f, t_0_b in board_rtvecs.items()
            }
            with stage("artifacts"):
                model_to_json(f"{output_folder}/cam{cam_idx}.json", model)
                object_to_json(
                    f"{output_folder}/cam{cam_idx}_poses.json",
                    {str(f): rt.to_json() for f, rt in sorted(new_rtvecs.items())},
                )
            recorder.log_camera_transform(
                cam_idx, np.linalg.inv(t_i_0[cam_idx].to_matrix())
            )
            with stage("validation"):
                rep = validation(
                    board, batches[cam_idx], model, new_rtvecs, recorder, cam_idx
                )
            rep_rms.append(rep)
            print(f"Cam {cam_idx} final params with extrinsic")
        with stage("artifacts"):
            write_report(f"{output_folder}/report.txt", True, rep_rms)
            object_to_json(f"{output_folder}/extrinsics.json", Extrinsics(t_i_0))
            _write_camchain(args, output_folder, cam_models, t_i_0)
        return cam_models, t_i_0
    # joint solve failed: fall back to per-camera results
    for cam_idx, (model, rtvecs) in enumerate(zip(intrinsics, cam_rtvecs)):
        with stage("validation"):
            rep = validation(board, batches[cam_idx], model, rtvecs, recorder, cam_idx)
        rep_rms.append(rep)
        with stage("artifacts"):
            model_to_json(f"{output_folder}/cam{cam_idx}.json", model)
            object_to_json(
                f"{output_folder}/cam{cam_idx}_poses.json",
                {str(f): rt.to_json() for f, rt in sorted(rtvecs.items())},
            )
    with stage("artifacts"):
        write_report(f"{output_folder}/report.txt", False, rep_rms)
        _write_camchain(args, output_folder, intrinsics)
    return intrinsics, None


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("CCRS_LOG", "WARNING").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"device: {device} ({name})")

    if args.tag_family_table:
        from .detect.families import family_from_table

        family = family_from_table(args.tag_family, args.tag_family_table)
    else:
        family = args.tag_family  # get_family raises helpfully for t25h7
    detector = TagDetector(family, device=device)
    board = setup_board(args)
    output_folder = setup_output_folder(args)
    recorder = Recorder(None if args.no_rerun else f"{output_folder}/logging.rrd")

    profile_dir = os.environ.get("CCRS_PROFILE_DIR")
    ctx = with_profiler(profile_dir) if profile_dir else contextlib.nullcontext()
    with ctx:
        generators = camera_generators(args.seed, args.cam_num, device)
        speculate = (
            not args.no_speculate and os.environ.get("CCRS_SPECULATE", "1") != "0"
        )
        specs = {} if speculate else None
        prewarm = Prewarm(args, detector, board, device, specs is not None)
        main.last_prewarm = prewarm
        batches = load_feature_data(
            args, detector, board, recorder, specs, generators, prewarm_cb=prewarm
        )
        intrinsics, cam_rtvecs = calibrate_all_cameras(
            args, board, batches, recorder, generators, device, specs
        )
        with stage("joint_ba"):
            t_cam_i_0 = init_camera_extrinsic(cam_rtvecs, device=device)
        for t in t_cam_i_0:
            print(f"r {t.rvec} t {t.tvec}")
        save_and_validate_results(
            args, output_folder, board, batches, intrinsics, cam_rtvecs,
            t_cam_i_0, recorder, device=device,
        )
        prewarm.join()
    if prewarm.seconds is not None:
        print(f"prewarm took {prewarm.seconds:.6f} sec")
    if prewarm.error is not None:
        print(f"prewarm error: {prewarm.error}")
    for cam_idx, spec in sorted((specs or {}).items()):
        if spec.error is not None:
            print(f"cam{cam_idx} speculation error: {spec.error}")
    if device.type == "cuda":
        from .ops.threshold_cuda import kernel_launches

        print(f"threshold kernel launches: {kernel_launches()} "
              f"(prewarm {detector.prewarm_launches})")
    print(f"results written to {output_folder}")


#: the last run's ``Prewarm`` (its ``error`` and ``seconds``), for callers
#: that run ``main`` in their own process
main.last_prewarm = None


if __name__ == "__main__":
    main()
