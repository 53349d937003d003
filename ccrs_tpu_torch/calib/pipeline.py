"""Per-camera calibration orchestration.

Port of ``ccrs_tpu/calib/pipeline.py``:
``init_and_calibrate_one_camera`` (``src/util.rs:831-911``) and the retry
ladder of ``calibrate_all_cameras`` (``src/bin/camera_calibration.rs:
205-246``): pick two init frames, attempt closed-form init up to 10 times,
convert the fitted UCM to the target model, then run the full bundle
adjustment.  Randomness comes from one ``torch.Generator`` that every
attempt draws from, so a run is reproducible from its seed.

``SpeculativeCalib`` solves on the tracked detector's provisional
detections on a thread of its own while the audits run, and hands the
result to the ladder as a warm start (``warm_provider``).  The warm start
changes where the final solve starts, never what it converges to: the
warm trial draws nothing from the ladder's generator, and a warm result
that fails the sanity gate leaves the cold ladder to run exactly as
without speculation.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel
from ..types import CalibParams, RvecTvec
from ..utils.profiling import count, stage, stage_prefix
from .convert import convert_model
from .frames import FrameBatch
from .initialize import find_best_two_frames, try_init_camera
from .single import calib_camera
from .validate import reprojection_errors

log = logging.getLogger(__name__)

MAX_INIT_ATTEMPTS = 10  # src/util.rs:855
MAX_TRIALS = 3  # bin/camera_calibration.rs:217

#: frame cap of the SPECULATIVE solve: it subsamples its provisional batch
#: to at most this many frames (the seed needs no more; the final solve
#: PnP-initializes or lerp-fills the skipped frames and re-solves them all)
SPEC_MAX_FRAMES = int(os.environ.get("CCRS_SPEC_MAX_FRAMES", "192"))


def spec_stride(n_frames: int) -> int:
    """Subsample stride of the speculative solve for ``n_frames``."""
    return max(1, -(-n_frames // SPEC_MAX_FRAMES))


def fill_poses_lerp(poses: np.ndarray, valid: np.ndarray) -> bool:
    """Fill invalid rows of a (F, 6) rvec|tvec pose array by per-component
    lerp between the valid neighbours, IN PLACE; rows outside the valid
    range clamp to the nearest.  Returns True when every row is filled.

    Axis-angle double cover: consecutive valid rvecs can land on opposite
    representatives (``r`` vs ``(1 - 2*pi/|r|) * r``), and a lerp across
    such a flip is a garbage rotation, so each valid rvec is first
    re-branched to the representative nearest its predecessor.
    """
    idx = np.flatnonzero(valid)
    if len(idx) < 2:
        return False
    r = poses[idx, :3].copy()
    for k in range(1, len(idx)):
        n = float(np.linalg.norm(r[k]))
        if n > 1e-9:
            alt = r[k] * (1.0 - 2.0 * np.pi / n)
            if np.sum((alt - r[k - 1]) ** 2) < np.sum((r[k] - r[k - 1]) ** 2):
                r[k] = alt
    poses[idx, :3] = r
    allf = np.arange(poses.shape[0])
    for d in range(6):
        poses[:, d] = np.interp(allf, idx, poses[idx, d])
    return True


def init_and_calibrate_one_camera(
    board: Board,
    batch: FrameBatch,
    target_model: GenericModel,
    calib_params: CalibParams,
    generator: torch.Generator,
    random_pick_two_frames: bool = False,
    rng=None,
    warm=None,
    polish_iters: int = 12,
    pose_init_f32: bool = False,
    out: Optional[dict] = None,
    device="cuda",
    solver: str = "f64",
) -> Optional[Tuple[GenericModel, Dict[int, RvecTvec]]]:
    """One calibration attempt on ``device``.

    ``warm``: optional (model, poses (F, 6), pose_valid (F,), init_frames)
    from a speculative calibration — skips init + convert (and draws
    nothing from ``generator``) and seeds the final BA, which still runs
    to full convergence on ``batch``.  ``polish_iters``,
    ``pose_init_f32`` and ``solver``: passed to ``calib_camera`` (the
    speculative solve asks for a float32 pose init and, on the mixed
    route, a 2-iteration polish).  ``out``: optional dict filled with
    ``init_frames`` (the two keyframes used) and ``gated`` ((median,
    result) when the sanity gate rejected a converged solve) — per call,
    since speculative solves run this on other threads."""
    if out is None:
        out = {}
    if warm is not None:
        final_model, warm_poses, warm_valid, init_frames = warm
        out["init_frames"] = init_frames
        one_focal = calib_params.one_focal or calib_params.fixed_focal is not None
        # a warm seed that covers EVERY frame makes the PnP init redundant;
        # a gate failure still falls back to the cold ladder
        with stage("calib/ba"):
            result = calib_camera(
                board, batch, final_model,
                xy_same_focal=one_focal,
                disabled_distortions=calib_params.disabled_distortion_num,
                fixed_focal=calib_params.fixed_focal is not None,
                warm_poses=warm_poses, warm_valid=warm_valid,
                skip_pose_init=bool(np.all(np.asarray(warm_valid) > 0)),
                device=device, solver=solver,
            )
        return _gate_result(board, batch, result, out)

    with stage("calib/pick-frames"):
        frame0, frame1 = find_best_two_frames(batch, random_pick_two_frames, rng)
    log.info("init frames: %d, %d", frame0, frame1)
    out["init_frames"] = (frame0, frame1)

    initial_camera = None
    with stage("calib/init"):
        for i in range(MAX_INIT_ATTEMPTS):
            initial_camera = try_init_camera(
                board, batch, frame0, frame1, generator, calib_params.fixed_focal,
                device=device, solver=solver,
            )
            if initial_camera is not None:
                break
            log.info("initialization attempt %d failed, retrying", i)
            if i >= 2:
                # a deterministic failure mode (e.g. a focal-degenerate
                # near-pure-translation pair) cannot be fixed by new RANSAC
                # draws, so re-pick the frames after 3 failures
                if rng is None:
                    seed = torch.randint(
                        0, 2**31 - 1, (), generator=generator, device=generator.device
                    )
                    rng = np.random.default_rng(int(seed))
                with stage("calib/pick-frames"):
                    frame0, frame1 = find_best_two_frames(batch, True, rng)
                log.info("re-picked init frames: %d, %d", frame0, frame1)
    if initial_camera is None or initial_camera.params[0] == 0.0:
        log.warning("calibration failed: could not initialize UCM")
        return None

    final_model = target_model.copy()
    final_model.set_w_h(round(initial_camera.width), round(initial_camera.height))
    with stage("calib/convert"):
        convert_model(
            initial_camera, final_model, calib_params.disabled_distortion_num,
            device=device,
        )
    log.info("converted to %s: %s", final_model.name, final_model.params)

    if calib_params.fixed_focal is not None:
        p = final_model.params.copy()
        p[0] = p[1] = calib_params.fixed_focal
        final_model.set_params(p)
        one_focal, fixed_focal = True, True
    else:
        one_focal, fixed_focal = calib_params.one_focal, False

    with stage("calib/ba"):
        result = calib_camera(
            board, batch, final_model,
            xy_same_focal=one_focal,
            disabled_distortions=calib_params.disabled_distortion_num,
            fixed_focal=fixed_focal,
            polish_iters=polish_iters,
            pose_init_f32=pose_init_f32,
            device=device, solver=solver,
        )
    return _gate_result(board, batch, result, out)


def _gate_result(board, batch, result, out):
    """Sanity gate: a "converged" solution with a median reprojection error
    above 2 px usually means the init was degenerate — report failure so
    the retry ladder picks new frames.  The gated result is kept in
    ``out["gated"]`` so the caller can fall back to the best attempt."""
    if result is None:
        return None
    model, rtvecs = result
    with stage("calib/sanity-gate"):
        per_frame = reprojection_errors(board, batch, model, rtvecs)
    if per_frame:
        med = float(np.median(np.concatenate([e for _, e, _ in per_frame])))
        if med > 2.0:
            log.warning("calibration sanity check failed (median %.2f px)", med)
            out["gated"] = (med, result)
            return None
    return result


def calibrate_camera_with_retries(
    board: Board,
    batch: FrameBatch,
    target_model: GenericModel,
    calib_params: CalibParams,
    generator: torch.Generator,
    seed: int = 0,
    warm_provider=None,
    device="cuda",
    solver: str = "f64",
) -> Tuple[GenericModel, Dict[int, RvecTvec]]:
    """<=3 trials on ``device``; retries pick random init frames
    (bin/camera_calibration.rs:217-242).  ``solver``: every trial's bundle
    adjustment, ``"f64"`` or ``"mixed"`` (see ``calib_camera``).

    ``warm_provider``: optional zero-argument callable returning a warm
    tuple (see init_and_calibrate_one_camera) or None — typically
    ``SpeculativeCalib.take``.  The warm attempt is a BONUS trial before
    the ladder: it draws nothing from ``generator``, and if it fails the
    sanity gate the cold ladder runs exactly as without speculation.
    ``last_warm_offered`` / ``last_spec_used`` record whether a warm seed
    existed and whether the returned result came from it.

    If every trial is rejected only by the sanity gate (the solve converged
    but the requested model cannot represent the data), the best gated
    attempt is returned with a warning, as the reference emits its result
    and lets report.txt carry the bad numbers.  Raises only when no trial
    produced a solution at all.

    Runs as the stage ``calib/camera`` and counts ``calib/cameras``,
    ``calib/warm-offered`` and ``calib/warm-used``."""
    with stage("calib/camera"):
        count("calib/cameras")
        rng = np.random.default_rng(seed)
        best_gated = None
        warm = None
        if warm_provider is not None:
            with stage("calib/spec-wait"):
                warm = warm_provider()
        calibrate_camera_with_retries.last_warm_offered = warm is not None
        calibrate_camera_with_retries.last_spec_used = False
        if warm is not None:
            count("calib/warm-offered")
        trials = ([None] if warm is not None else []) + list(range(MAX_TRIALS))
        for trial in trials:
            attempt: dict = {}
            result = init_and_calibrate_one_camera(
                board, batch, target_model, calib_params, generator,
                random_pick_two_frames=trial is not None and trial > 0, rng=rng,
                warm=warm if trial is None else None, out=attempt, device=device,
                solver=solver,
            )
            if result is not None:
                calibrate_camera_with_retries.last_spec_used = trial is None
                if trial is None:
                    count("calib/warm-used")
                calibrate_camera_with_retries.last_init_frames = attempt.get("init_frames")
                return result
            gated = attempt.get("gated")
            if gated is not None and (best_gated is None or gated[0] < best_gated[0]):
                # keep the trial's init frames with the attempt: the keyframe
                # markers must describe the attempt actually returned
                best_gated = gated + (attempt.get("init_frames"),)
        if best_gated is not None:
            log.warning(
                "all %d trials failed the sanity gate; returning the best "
                "attempt (median %.2f px)", MAX_TRIALS, best_gated[0],
            )
            calibrate_camera_with_retries.last_init_frames = best_gated[2]
            return best_gated[1]
        raise RuntimeError(f"Failed to calibrate camera after {MAX_TRIALS} trials")


# per-RETURN metadata of the ladder: the keyframes (two init frames) of the
# attempt it returned, read by the CLI's Rerun markers, and whether a warm
# seed was offered and used.  The ladder runs on the caller's thread, one
# camera after another (speculative solves never run the ladder).
calibrate_camera_with_retries.last_init_frames = None
calibrate_camera_with_retries.last_warm_offered = False
calibrate_camera_with_retries.last_spec_used = False


class SpeculativeCalib:
    """Overlap calibration with the tracked detector's audit rounds.

    The tracked detector hands its PROVISIONAL per-frame detections to
    ``TagDetector.on_provisional`` before its cold audit sweeps run; the
    audits correct only a few frames, so a calibration solved on the
    provisional data lands in the final optimum's basin.  This class runs
    init + convert + BA on a thread of its own while detection finishes,
    then hands the result to
    ``calibrate_camera_with_retries(warm_provider=spec.take)``: the FINAL
    solve still runs on the final detections to full convergence, with the
    same gates; it only starts closer.

    Randomness: at construction the speculation copies the state of the
    camera's ``generator`` into a generator of its own and draws only from
    that copy, so its init makes the draws trial 0 of the ladder would
    make and never moves the ladder's generator.  Construct it before the
    ladder draws.  The solve runs on the generator's device, with
    ``solver`` (``"mixed"``: a seed-quality 2-iteration polish).

    Failures are not hidden: an exception in the thread leaves ``take()``
    returning None (the ladder runs cold) and is kept in ``error`` (its
    repr).

    Usage::

        spec = SpeculativeCalib(board, times, target_model, params, gen, w, h)
        detector.on_provisional = spec.on_provisional
        dets = detector.detect_batch(...)
        batch = FrameBatch.from_detections(dets, ...)
        result = calibrate_camera_with_retries(
            board, batch, model, params, gen, warm_provider=spec.take,
            device=...)
    """

    def __init__(self, board, times, target_model, calib_params, generator, width, height,
                 solver: str = "f64"):
        own = torch.Generator(device=generator.device)
        own.set_state(generator.get_state())
        self._args = (board, list(times), target_model, calib_params, own, width, height)
        self._solver = solver
        self._thread = None
        self._warm = None
        self.error = None

    def on_provisional(self, results) -> None:
        """Detector hook: snapshot the provisional detection list (one
        {tag_id: corners} dict per frame) and solve on a daemon thread."""
        if self._thread is not None:  # one speculation per batch
            return
        if len(results) != len(self._args[1]):
            # a partial batch: its frame indices would not map to the batch
            return
        snapshot = [dict(r) for r in results]
        self._thread = threading.Thread(
            target=self._run, args=(snapshot,), name="ccrs-spec", daemon=True
        )
        self._thread.start()

    def _run(self, results) -> None:
        board, times, target_model, calib_params, generator, w, h = self._args
        try:
            F_all = len(results)
            stride = spec_stride(F_all)
            sub_idx = range(0, F_all, stride)
            with stage_prefix("spec/"):
                batch = FrameBatch.from_detections(
                    [results[i] for i in sub_idx], [times[i] for i in sub_idx],
                    board, w, h,
                )
                attempt: dict = {}
                res = init_and_calibrate_one_camera(
                    board, batch, target_model, calib_params, generator,
                    polish_iters=2, pose_init_f32=True, out=attempt,
                    device=generator.device, solver=self._solver,
                )
            if res is None:
                return
            model, rtvecs = res
            poses = np.zeros((F_all, 6), np.float64)
            valid = np.zeros((F_all,), np.float64)
            for i, rt in rtvecs.items():
                poses[i * stride, :3] = rt.rvec
                poses[i * stride, 3:] = rt.tvec
                valid[i * stride] = 1.0
            # Fill the unsolved frames by the rvec-continuity-safe lerp, so
            # the final solve can skip its PnP init — but ONLY across short
            # gaps: a lerp over a long run of unsolved frames (fast motion
            # the audits repair after this solve) seeds the final solve in
            # a wrong basin, so long-gap frames keep valid=0 and are
            # PnP-initialized as the cold path would.
            idx = np.flatnonzero(valid)
            max_gap = 3 * stride
            gaps_ok = (
                len(idx) >= 2
                and idx[0] <= max_gap
                and (F_all - 1 - idx[-1]) <= max_gap
                and int(np.diff(idx).max()) <= max_gap
            )
            if gaps_ok and fill_poses_lerp(poses, valid):
                valid[:] = 1.0
            init_frames = attempt.get("init_frames")
            if init_frames is not None:
                # sub-batch keyframes back to full-batch frame numbers
                init_frames = tuple(f * stride for f in init_frames)
            self._warm = (model, poses, valid, init_frames)
        except Exception as e:  # the ladder then runs cold; the error stays visible
            log.exception("speculative calibration failed; running cold")
            self.error = repr(e)

    @property
    def started(self) -> bool:
        """Whether the hook fired and the speculation thread started."""
        return self._thread is not None

    def take(self):
        """Join the speculation thread and return the warm tuple (or None
        when the speculation never started, found no solution, or
        failed — see ``error``)."""
        if self._thread is not None:
            self._thread.join()
        return self._warm
