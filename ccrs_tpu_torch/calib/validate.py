"""Validation metrics: median and best-99% reprojection error.

Port of ``ccrs_tpu/calib/validate.py`` (``validation``,
``src/util.rs:721-826``): project the board through the final model at each
estimated pose, collect per-point L2 pixel errors, report (avg of best 99%,
median).  The metric math runs in host numpy float64 and the projection in
torch float64 on the CPU, wherever the calibration ran.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..board import Board
from ..models import GenericModel
from ..types import RvecTvec
from .frames import FrameBatch


def reprojection_errors(
    board: Board,
    batch: FrameBatch,
    model: GenericModel,
    rtvecs: Dict[int, RvecTvec],
):
    """Per-frame per-point reprojection errors, all frames projected in
    one batched call.

    Returns list of (frame_idx, errors (n_i,), p2ds (n_i,2)).
    """
    frames = [i for i, _ in sorted(rtvecs.items()) if batch.mask[i].any()]
    if not frames:
        return []
    p3c = np.stack([rtvecs[i].transform(board.p3d) for i in frames])  # (F,N,3)
    proj, _ = model.project(p3c.reshape(-1, 3))
    proj = proj.reshape(len(frames), board.n_corners, 2)
    out = []
    for k, i in enumerate(frames):
        m = batch.mask[i]
        err = np.linalg.norm(proj[k][m] - batch.p2d[i][m], axis=-1)
        out.append((i, err, batch.p2d[i][m]))
    return out


def validation(
    board: Board,
    batch: FrameBatch,
    model: GenericModel,
    rtvecs: Dict[int, RvecTvec],
) -> Tuple[float, float]:
    """(avg of best 99%, median) reprojection error in pixels
    (``src/util.rs:778-795``)."""
    per_frame = reprojection_errors(board, batch, model, rtvecs)
    errs = np.concatenate([e for _, e, _ in per_frame]) if per_frame else np.array([0.0])
    print(f"total pts: {errs.size}")
    errs_sorted = np.sort(errs)
    median = float(errs_sorted[errs_sorted.size // 2])
    n99 = errs_sorted.size * 99 // 100
    avg99 = float(errs_sorted[:n99].sum() / max(n99, 1))
    print(f"Median reprojection error: {median} px")
    print(f"Avg reprojection error of 99%: {avg99} px")
    return avg99, median
