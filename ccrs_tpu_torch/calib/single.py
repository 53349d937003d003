"""Single-camera bundle-adjustment calibration.

Port of the cold path of ``ccrs_tpu/calib/single.py`` (``calib_camera``,
``src/util.rs:384-490``): the per-feature reprojection factor graph becomes
one ``(F, N, 2)`` masked residual tensor; per-frame pose init is the
batched unproject -> planar-PnP path of ``src/util.rs:418-439`` with the
<10-valid frame skip expressed as a frame mask.

Two solvers, chosen by ``solver=``: ``"f64"`` (the default) is the float64
``ba_solve`` from the first iteration; ``"mixed"`` is the JAX package's
route, ``ba_solve_mixed`` (a float32 descent, then a float64 polish of at
most ``polish_iters`` iterations).  ``polish_iters`` means something on the
mixed route only: a float64 solve has no separate polish.  The warm-start
arguments (``warm_poses``, ``warm_valid``, ``skip_pose_init``) and the
float32 pose init (``pose_init_f32``) of the speculative calibration are
ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_fn, unproject_fn
from ..solve.lm import ba_solve, ba_solve_mixed, expand_theta, reduce_params
from ..solve.pnp import solve_pnp_planar
from ..types import RvecTvec
from .frames import FrameBatch

MIN_PNP_POINTS = 10  # src/util.rs:431
F64 = torch.float64
SOLVERS = ("f64", "mixed")


def check_solver(solver: str) -> str:
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, not {solver!r}")
    return solver


def build_bounds(model: GenericModel, one_focal: bool):
    """Parameter bounds mirroring set_problem_parameter_bound
    (``src/util.rs:29-49``): focals in (0, 1e4), cx/cy in (0, w/h),
    distortion bounds from the model table."""
    n = model.n_params
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    lo[0:2], hi[0:2] = 0.0, 1e4
    lo[2], hi[2] = 0.0, model.width
    lo[3], hi[3] = 0.0, model.height
    for idx, (l, h) in model.distortion_params_bound().items():
        lo[idx], hi[idx] = l, h
    if one_focal:
        lo = np.delete(lo, 1)
        hi = np.delete(hi, 1)
    return lo, hi


def disabled_free_mask(model: GenericModel, one_focal: bool, disabled: int):
    """Free-mask that fixes the last ``disabled`` distortion params
    (set_problem_parameter_disabled, ``src/util.rs:50-71``); the caller also
    zeroes those entries in theta0."""
    n = model.n_params - (1 if one_focal else 0)
    free = np.ones(n)
    for i in range(disabled):
        free[n - 1 - i] = 0.0
    return free


def pose_init(unproj, params, p2d, mask, p3d):
    """Per-frame pose init: unproject -> x/z -> batched planar PnP.

    params (P,), p2d (F, N, 2), mask (F, N) bool, p3d (N, 3), all on one
    device.  Returns (poses (F, 6), frame_valid (F,) 0/1) — frames with
    fewer than MIN_PNP_POINTS valid unprojections are masked out."""
    rays, uvalid = unproj(params, p2d)
    uvalid = uvalid & mask
    z = rays[..., 2:3]
    z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    obs = rays[..., :2] / z
    obs = torch.where(torch.isfinite(obs), obs, torch.zeros_like(obs))
    frame_valid = (uvalid.sum(dim=1) >= MIN_PNP_POINTS).to(params.dtype)
    w = uvalid.to(params.dtype)
    w_safe = torch.where(frame_valid[:, None] > 0, w, torch.ones_like(w))
    r, t = solve_pnp_planar(p3d.expand(p2d.shape[0], -1, -1), obs, w_safe)
    poses = torch.cat([r, t], dim=1)
    poses = torch.where(torch.isfinite(poses), poses, torch.zeros_like(poses))
    return poses, frame_valid


def init_frame_poses(board: Board, batch: FrameBatch, model: GenericModel, device="cuda"):
    """Batched pose init for every frame on ``device``: unproject the
    observations through the current model, planar PnP on the valid ones
    (``src/util.rs:418-439``).

    Returns (poses (F, 6), frame_valid (F,)) as numpy arrays — frames with
    fewer than MIN_PNP_POINTS valid unprojections are masked out.
    """
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    poses, frame_valid = pose_init(
        unproject_fn(model.name), t(model.params), t(batch.p2d),
        torch.as_tensor(batch.mask, device=device), t(board.p3d),
    )
    return poses.cpu().numpy(), frame_valid.cpu().numpy()


def calib_camera_solve(
    unproj, proj, theta0, params_full, p2d, mask, p3d, lo, hi, free,
    one_focal: bool, max_iters: int = 60, huber_delta: float = 1.0,
    warm_poses=None, warm_valid=None, skip_pose_init: bool = False,
    pose_init_f32: bool = False, solver: str = "f64", polish_iters: int = 12,
):
    """Pose init through ``params_full`` then the Schur LM from ``theta0``;
    every argument a tensor on the solve's device.  Returns
    (BAResult, frame_valid (F,)).  ``solver``: ``"f64"`` solves with
    ``ba_solve``, ``"mixed"`` with ``ba_solve_mixed`` and its
    ``polish_iters``.

    ``warm_poses`` (F, 6) / ``warm_valid`` (F,): frames with
    ``warm_valid > 0`` start from the warm pose instead of the PnP pose.
    ``skip_pose_init``: no PnP at all; every frame starts from
    ``warm_poses`` and a frame is valid when it has >= MIN_PNP_POINTS
    observed corners (the PnP path counts unprojectable corners, a
    tighter test).  ``pose_init_f32``: the PnP runs in float32 (only for
    seed-quality solves; the poses come back as float64)."""
    if skip_pose_init:
        poses0 = warm_poses
        frame_valid = (mask.sum(dim=1) >= MIN_PNP_POINTS).to(theta0.dtype)
    else:
        if pose_init_f32:
            f32 = torch.float32
            poses0, frame_valid = pose_init(
                unproj, params_full.to(f32), p2d.to(f32), mask, p3d.to(f32)
            )
        else:
            poses0, frame_valid = pose_init(unproj, params_full, p2d, mask, p3d)
        poses0 = poses0.to(theta0.dtype)
        frame_valid = frame_valid.to(theta0.dtype) * (mask.sum(dim=1) > 0)
        if warm_poses is not None:
            poses0 = torch.where((warm_valid > 0)[:, None], warm_poses, poses0)
    args = (proj, theta0, poses0, p3d, p2d, mask.to(theta0.dtype), lo, hi, free,
            frame_valid)
    if check_solver(solver) == "mixed":
        res = ba_solve_mixed(*args, one_focal=one_focal, max_iters=max_iters,
                             huber_delta=huber_delta, polish_iters=polish_iters)
    else:
        res = ba_solve(*args, one_focal=one_focal, max_iters=max_iters,
                       huber_delta=huber_delta)
    return res, frame_valid


def calib_camera(
    board: Board,
    batch: FrameBatch,
    camera: GenericModel,
    xy_same_focal: bool,
    disabled_distortions: int,
    fixed_focal: bool,
    warm_poses: Optional[np.ndarray] = None,
    warm_valid: Optional[np.ndarray] = None,
    polish_iters: int = 12,
    skip_pose_init: bool = False,
    pose_init_f32: bool = False,
    device="cuda",
    solver: str = "f64",
) -> Optional[Tuple[GenericModel, Dict[int, RvecTvec]]]:
    """Full single-camera BA (``src/util.rs:384-490``) on ``device``.

    ``warm_poses`` (F, 6) / ``warm_valid`` (F,): optional pose warm start
    (the speculative solve's poses seed the final one); the intrinsics
    warm start rides ``camera``.  ``skip_pose_init`` drops the PnP init
    (requires ``warm_poses`` covering every frame), ``pose_init_f32`` runs
    it in float32 (see ``calib_camera_solve``).  ``solver``: ``"f64"``
    (``ba_solve``) or ``"mixed"`` (``ba_solve_mixed`` with
    ``polish_iters``, the JAX package's route); the fixed-focal re-solve
    is float64 on both.

    Returns (calibrated model, {frame_idx: board->camera pose}) or None.
    """
    if skip_pose_init and warm_poses is None:
        raise ValueError("skip_pose_init requires warm_poses")
    check_solver(solver)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    params0 = camera.params.copy()
    theta0 = reduce_params(torch.as_tensor(params0), xy_same_focal).numpy()
    lo, hi = build_bounds(camera, xy_same_focal)
    free = disabled_free_mask(camera, xy_same_focal, disabled_distortions)
    # zero the disabled distortion entries (util.rs:69) and widen their
    # bounds so the initial clamp cannot move a pinned zero
    theta0 = np.where(free == 0.0, 0.0, theta0)
    lo = np.where(free == 0.0, -np.inf, lo)
    hi = np.where(free == 0.0, np.inf, hi)

    p3d = t(board.p3d)
    p2d = t(batch.p2d)
    mask = torch.as_tensor(batch.mask, device=device)
    res, frame_valid = calib_camera_solve(
        unproject_fn(camera.name), project_fn(camera.name), t(theta0),
        t(camera.params), p2d, mask, p3d, t(lo), t(hi), t(free),
        one_focal=xy_same_focal,
        warm_poses=None if warm_poses is None else t(warm_poses),
        warm_valid=None if warm_valid is None else t(warm_valid),
        skip_pose_init=skip_pose_init, pose_init_f32=pose_init_f32,
        solver=solver, polish_iters=polish_iters,
    )
    if float(frame_valid.sum()) == 0 or not bool(torch.isfinite(res.cost)):
        return None
    theta, poses = res.theta, res.poses
    if fixed_focal:
        # re-solve with f clamped at the requested value (util.rs:459-464)
        theta = theta.clone()
        theta[0] = float(params0[0])
        free_fix = free.copy()
        free_fix[0] = 0.0
        res = ba_solve(
            project_fn(camera.name), theta, poses, p3d, p2d, mask.to(F64),
            t(lo), t(hi), t(free_fix), frame_valid,
            one_focal=xy_same_focal, huber_delta=1.0,
        )
        theta, poses = res.theta, res.poses

    out_model = camera.copy()
    out_model.set_params(expand_theta(theta, xy_same_focal).cpu().numpy())
    poses = poses.cpu().numpy()
    rtvecs = {
        int(i): RvecTvec(poses[i, :3], poses[i, 3:])
        for i in np.flatnonzero(frame_valid.cpu().numpy() > 0)
    }
    return out_model, rtvecs
