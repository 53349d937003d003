"""Closed-form camera initialization.

Port of ``ccrs_tpu/calib/initialize.py``: the reference flow
try_init_camera -> init_ucm (``src/util.rs:107-378``) and the
frame-selection heuristics (``src/util.rs:168-219``), on the batched
solvers:

- the 1000-hypothesis radial-distortion-homography RANSAC runs as one batch
  (``solve.homography``);
- the division-model pose init (``src/optimization/linear.rs:5-21``) is the
  planar PnP, batched over both init frames;
- the [f, alpha] UCM fit and the two-frame full UCM calibration are both
  ``ba_solve`` instances.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_ucm, unproject_ucm
from ..solve.homography import (
    homography_to_focal_traced,
    radial_distortion_homography,
)
from ..solve.lm import ba_solve, expand_theta
from ..solve.pnp import solve_pnp_planar
from .frames import FrameBatch
from .single import calib_camera_solve

F64 = torch.float64


def find_best_two_frames(batch: FrameBatch, random_pick: bool = False, rng=None):
    """Pick the two init frames (``src/util.rs:168-219``).

    Among frames with the maximum detection count: frame A = largest
    covered area, frame B = farthest feature-centroid from the group mean.
    ``random_pick`` (retry path) picks two random max-count frames.
    """
    counts = batch.counts()
    max_det = counts.max()
    cand = np.flatnonzero(counts == max_det)
    if len(cand) < 2:
        # widen to near-max frames so the two init frames are distinct
        # when possible (the reference can return the same frame twice)
        near = np.flatnonzero(counts >= 0.9 * max_det)
        if len(near) >= 2:
            cand = near
        else:
            order = np.argsort(counts)[::-1]
            cand = order[: min(2, len(order))]
    if random_pick:
        rng = rng or np.random.default_rng()
        pick = rng.permutation(cand)
        return int(pick[0]), int(pick[1 % len(pick)])
    # feature centroids
    m = batch.mask[cand][..., None]
    pts = batch.p2d[cand]
    centers = (pts * m).sum(1) / np.maximum(m.sum(1), 1)
    avg_all = centers.mean(0)
    d2 = ((centers - avg_all) ** 2).sum(-1)
    # covered axis-aligned area
    big = np.where(batch.mask[cand][..., None], pts, np.nan)
    area = (np.nanmax(big[:, :, 0], 1) - np.nanmin(big[:, :, 0], 1)) * (
        np.nanmax(big[:, :, 1], 1) - np.nanmin(big[:, :, 1], 1)
    )
    idx_area = cand[int(np.argmax(area))]
    # farthest-centroid frame, distinct from idx_area when possible
    order = np.argsort(d2)[::-1]
    idx_far = idx_area
    for j in order:
        if cand[j] != idx_area:
            idx_far = cand[j]
            break
    return int(idx_area), int(idx_far)


def _normalize(p2d, width, height):
    half_w, half_h = width / 2.0, height / 2.0
    half = max(half_w, half_h)
    return (p2d - np.array([half_w, half_h])) / half, half


def init_ucm(
    q0, q1, pair_mask, p3d, p2d, masks, half: float, wh,
    generator=None, fixed_focal: Optional[float] = None, idx=None,
    solver: str = "f64",
):
    """One init attempt on tensors of one device:

      RANSAC radial-distortion homography -> closed-form focal ->
      division-model planar PnP poses -> two-frame [f, alpha] UCM fit ->
      two-frame full UCM calibration (pose re-init + BA).

    Args:
      q0, q1: (N, 2) center/half-size-normalized observations of the two
        init frames; pair_mask (N,) both-observed.
      p3d: (N, 3) board points; p2d (2, N, 2) raw pixel observations;
        masks (2, N) per-frame observation masks.
      half: normalization half-size; wh: (2,) tensor (width, height).
      generator / idx: RANSAC draws (see radial_distortion_homography).
      solver: the two-frame full calibration's solver, ``"f64"`` or
        ``"mixed"`` (``calib_camera_solve``; the JAX package runs it mixed).

    Returns (params (5,) full UCM, ok) with ok a 0-d bool tensor.
    """
    dtype, dev = q0.dtype, q0.device

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    lam, Hm, score = radial_distortion_homography(
        q0, q1, pair_mask, generator=generator, idx=idx
    )
    f_unit, f_ok = homography_to_focal_traced(Hm)
    ok = torch.isfinite(score) & f_ok & torch.isfinite(f_unit) & (f_unit > 0)

    init_f = c(fixed_focal) if fixed_focal is not None else f_unit * half
    init_alpha = torch.abs(lam)
    w2 = masks.to(dtype)

    # division-model pose init (linear.rs:5-21): undo r' = r (1 + lam r^2)
    q = torch.stack([q0, q1])
    sc = 1.0 + lam * torch.sum(q * q, dim=-1)
    r, t = solve_pnp_planar(p3d.expand(2, -1, -1), q / sc[..., None], w2)
    poses0 = torch.cat([r, t], dim=1)

    # stage 1: reduced UCM theta = [f, cx, cy, alpha], cx/cy frozen at the
    # image center, f bounded to [f/3, 3f] (util.rs:345-346); loose rtol —
    # it only seeds stage 2
    zero = torch.zeros_like(init_f)
    theta0 = torch.stack([init_f, wh[0] / 2.0, wh[1] / 2.0, init_alpha])
    lo1 = torch.stack([init_f / 3.0, zero, zero, c(1e-6)])
    hi1 = torch.stack([init_f * 3.0, wh[0], wh[1], c(1.0)])
    free1 = c([0.0 if fixed_focal is not None else 1.0, 0.0, 0.0, 1.0])
    res1 = ba_solve(
        project_ucm, theta0, poses0, p3d, p2d, w2, lo1, hi1, free1,
        torch.ones(2, dtype=dtype, device=dev), one_focal=True,
        huber_delta=1.0, rtol=1e-6,
    )
    params1 = expand_theta(res1.theta, True)  # (5,) full UCM

    # stage 2: two-frame full UCM calibration with standard bounds
    # (util.rs:364-374) — pose re-init through the fitted model + BA
    lo2 = c([0.0, 0.0, 0.0, 1e-6])
    hi2 = torch.stack([c(1e4), wh[0], wh[1], c(1.0)])
    free2 = c([0.0 if fixed_focal is not None else 1.0, 1.0, 1.0, 1.0])
    theta2 = torch.stack([params1[0], params1[2], params1[3], params1[4]])
    res2, frame_valid = calib_camera_solve(
        unproject_ucm, project_ucm, theta2, params1, p2d, masks, p3d,
        lo2, hi2, free2, one_focal=True, solver=solver,
    )
    params = expand_theta(res2.theta, True)
    ok = (
        ok
        & torch.isfinite(res2.cost)
        & (torch.sum(frame_valid) > 0)
        & torch.all(torch.isfinite(params))
        & (params[0] != 0.0)
    )
    return params, ok


def try_init_camera(
    board: Board,
    batch: FrameBatch,
    frame0: int,
    frame1: int,
    generator: torch.Generator,
    fixed_focal: Optional[float] = None,
    device="cuda",
    solver: str = "f64",
) -> Optional[GenericModel]:
    """One initialization attempt (``src/util.rs:107-159``) on ``device``;
    ``solver`` as in ``init_ucm``.

    Returns a fitted UCM model or None (the caller retries; the generator
    has advanced, so the retry draws new RANSAC hypotheses).
    """
    q0, half = _normalize(batch.p2d[frame0], batch.width, batch.height)
    q1, _ = _normalize(batch.p2d[frame1], batch.width, batch.height)
    sel = [frame0, frame1]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    params, ok = init_ucm(
        t(q0), t(q1),
        torch.as_tensor(batch.mask[frame0] & batch.mask[frame1], device=device),
        t(board.p3d), t(batch.p2d[sel]),
        torch.as_tensor(batch.mask[sel], device=device),
        float(half), t([batch.width, batch.height]),
        generator=generator, fixed_focal=fixed_focal, solver=solver,
    )
    if not bool(ok):
        return None
    params = params.cpu().numpy()
    if not np.isfinite(params).all() or params[0] == 0.0:
        return None
    return GenericModel("ucm", params, batch.width, batch.height)
