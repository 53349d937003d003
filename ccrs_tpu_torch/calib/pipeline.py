"""Per-camera calibration orchestration, cold path.

Port of the cold branch of ``ccrs_tpu/calib/pipeline.py``:
``init_and_calibrate_one_camera`` (``src/util.rs:831-911``) and the retry
ladder of ``calibrate_all_cameras`` (``src/bin/camera_calibration.rs:
205-246``): pick two init frames, attempt closed-form init up to 10 times,
convert the fitted UCM to the target model, then run the full bundle
adjustment.  Randomness comes from one ``torch.Generator`` that every
attempt draws from, so a run is reproducible from its seed.

Speculative calibration and warm starts are not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel
from ..types import CalibParams, RvecTvec
from .convert import convert_model
from .frames import FrameBatch
from .initialize import find_best_two_frames, try_init_camera
from .single import calib_camera
from .validate import reprojection_errors

log = logging.getLogger(__name__)

MAX_INIT_ATTEMPTS = 10  # src/util.rs:855
MAX_TRIALS = 3  # bin/camera_calibration.rs:217


def init_and_calibrate_one_camera(
    board: Board,
    batch: FrameBatch,
    target_model: GenericModel,
    calib_params: CalibParams,
    generator: torch.Generator,
    random_pick_two_frames: bool = False,
    rng=None,
    out: Optional[dict] = None,
    device="cpu",
) -> Optional[Tuple[GenericModel, Dict[int, RvecTvec]]]:
    """One calibration attempt on ``device``.  ``out``: optional dict
    filled with ``init_frames`` (the two keyframes used) and ``gated``
    ((median, result) when the sanity gate rejected a converged solve)."""
    if out is None:
        out = {}
    frame0, frame1 = find_best_two_frames(batch, random_pick_two_frames, rng)
    log.info("init frames: %d, %d", frame0, frame1)
    out["init_frames"] = (frame0, frame1)

    initial_camera = None
    for i in range(MAX_INIT_ATTEMPTS):
        initial_camera = try_init_camera(
            board, batch, frame0, frame1, generator, calib_params.fixed_focal,
            device=device,
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
            frame0, frame1 = find_best_two_frames(batch, True, rng)
            log.info("re-picked init frames: %d, %d", frame0, frame1)
    if initial_camera is None or initial_camera.params[0] == 0.0:
        log.warning("calibration failed: could not initialize UCM")
        return None

    final_model = target_model.copy()
    final_model.set_w_h(round(initial_camera.width), round(initial_camera.height))
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

    result = calib_camera(
        board, batch, final_model,
        xy_same_focal=one_focal,
        disabled_distortions=calib_params.disabled_distortion_num,
        fixed_focal=fixed_focal,
        device=device,
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
    device="cpu",
) -> Tuple[GenericModel, Dict[int, RvecTvec]]:
    """<=3 trials on ``device``; retries pick random init frames
    (bin/camera_calibration.rs:217-242).

    If every trial is rejected only by the sanity gate (the solve converged
    but the requested model cannot represent the data), the best gated
    attempt is returned with a warning, as the reference emits its result
    and lets report.txt carry the bad numbers.  Raises only when no trial
    produced a solution at all."""
    rng = np.random.default_rng(seed)
    best_gated = None
    for trial in range(MAX_TRIALS):
        attempt: dict = {}
        result = init_and_calibrate_one_camera(
            board, batch, target_model, calib_params, generator,
            random_pick_two_frames=trial > 0, rng=rng, out=attempt,
            device=device,
        )
        if result is not None:
            return result
        gated = attempt.get("gated")
        if gated is not None and (best_gated is None or gated[0] < best_gated[0]):
            best_gated = gated
    if best_gated is not None:
        log.warning(
            "all %d trials failed the sanity gate; returning the best "
            "attempt (median %.2f px)", MAX_TRIALS, best_gated[0],
        )
        return best_gated[1]
    raise RuntimeError(f"Failed to calibrate camera after {MAX_TRIALS} trials")
