"""Multi-camera extrinsic initialization + joint calibration.

Port of ``ccrs_tpu/calib/multi.py``: ``init_camera_extrinsic``
(``src/util.rs:511-561``) and ``calib_all_camera_with_extrinsics``
(``src/util.rs:567-715``).  Each camera's extrinsic against cam0 is
initialized by a pose-graph solve over the frames both cameras saw (Huber
0.5 SE3 residuals on the dense LM core), then one joint Schur BA runs over
all cameras' intrinsics, the camera extrinsics and the shared board poses.

The joint solve runs in float64 (``solver="f64"``, the default) or as the
JAX package's float32 descent plus float64 polish (``solver="mixed"``).
When the device mesh (``parallel.mesh.make_mesh``) holds more than one
device of the requested device's type and F is at least its size, it is
frame-sharded over the mesh (``multi_ba_sharded`` /
``multi_ba_sharded_mixed``), as ``ccrs_tpu`` shards it over
``jax.devices()``; otherwise it runs on one device (``ba_solve_multi`` /
``ba_solve_multi_mixed``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel
from ..models.projections import project_fn
from ..parallel.mesh import mesh_for, multi_ba_sharded, multi_ba_sharded_mixed
from ..solve import se3
from ..solve.lm import (
    LMOptions,
    ba_solve_multi,
    ba_solve_multi_mixed,
    expand_theta,
    lm_solve,
    reduce_params,
)
from ..types import RvecTvec
from .frames import FrameBatch
from .single import build_bounds, check_solver, disabled_free_mask

log = logging.getLogger(__name__)

F64 = torch.float64


def init_camera_extrinsic(
    cam_rtvecs: List[Dict[int, RvecTvec]], device="cuda"
) -> List[RvecTvec]:
    """Estimate T_cam_i<-cam0 from frames seen by both cameras."""
    out = [RvecTvec.identity()]
    for cam_i in range(1, len(cam_rtvecs)):
        common = sorted(set(cam_rtvecs[0]) & set(cam_rtvecs[cam_i]))
        if not common:
            log.warning("cam%d shares no frames with cam0; identity extrinsic", cam_i)
            out.append(RvecTvec.identity())
            continue

        def stack(rts):
            rows = [np.concatenate([rts[f].rvec, rts[f].tvec]) for f in common]
            return torch.as_tensor(np.stack(rows), dtype=F64, device=device)

        t0b, tib = stack(cam_rtvecs[0]), stack(cam_rtvecs[cam_i])
        # init from the first common frame: T_i_0 = T_i_b * T_0_b^-1
        init = cam_rtvecs[cam_i][common[0]].compose(cam_rtvecs[0][common[0]].inverse())
        x0 = torch.as_tensor(
            np.concatenate([init.rvec, init.tvec]), dtype=F64, device=device
        )
        r_inv, t_inv = se3.inverse(tib[:, :3], tib[:, 3:])

        def residual(x):
            # log( T_i_b^-1 * T_i_0 * T_0_b ) per common frame (SE3Factor,
            # factors.rs:248-271)
            rv_a, tv_a = se3.compose(
                x[:3].expand_as(t0b[:, :3]), x[3:].expand_as(t0b[:, 3:]),
                t0b[:, :3], t0b[:, 3:],
            )
            r_d, t_d = se3.compose(r_inv, t_inv, rv_a, tv_a)
            blocks = torch.cat([r_d, t_d], dim=1)  # (K, 6)
            return blocks, torch.ones(blocks.shape[0], dtype=x.dtype, device=x.device)

        x, _, _ = lm_solve(residual, x0, opts=LMOptions(huber_delta=0.5))
        x = x.cpu().numpy()
        log.info("extrinsic cam%d<-cam0: rvec %s tvec %s", cam_i, x[:3], x[3:])
        out.append(RvecTvec(x[:3], x[3:]))
    return out


def calib_all_camera_with_extrinsics(
    board: Board,
    cameras: List[GenericModel],
    t_cam_i_0: List[RvecTvec],
    cam_rtvecs: List[Dict[int, RvecTvec]],
    batches: List[FrameBatch],
    xy_same_focal: bool,
    disabled_distortions: int,
    cam0_fixed_focal: bool,
    device="cuda",
    solver: str = "f64",
) -> Optional[Tuple[List[GenericModel], List[RvecTvec], Dict[int, RvecTvec]]]:
    """One joint problem over all cameras (``src/util.rs:567-715``) on
    ``device``, frame-sharded over the mesh when it holds more than one
    device of that type; ``solver``: ``"f64"`` or ``"mixed"`` (see the
    module docstring).

    Returns (intrinsics, T_i_0 per camera, board poses {frame: T_0_b}) or
    None if the solve diverges (the caller falls back to per-camera
    results, bin/camera_calibration.rs:320-343).
    """
    mixed = check_solver(solver) == "mixed"
    C = len(cameras)
    F = max(b.n_frames for b in batches)
    N = board.n_corners
    name = cameras[0].name
    if any(c.name != name for c in cameras):
        raise ValueError("all cameras must share a model type")
    k = cameras[0].n_params - (1 if xy_same_focal else 0)

    theta0 = np.zeros((C, k))
    lo = np.zeros((C, k))
    hi = np.zeros((C, k))
    free = np.zeros((C, k))
    p2d = np.zeros((C, F, N, 2))
    w = np.zeros((C, F, N))
    cam_frame_valid = np.zeros((C, F))
    ext0 = np.zeros((C, 6))

    # board-pose inits: cam0's estimate wins; else the first camera that saw it
    pose0_map: Dict[int, np.ndarray] = {}
    for c in range(C):
        for f, rt in sorted(cam_rtvecs[c].items()):
            if f in pose0_map:
                continue
            if c == 0:
                pose0_map[f] = np.concatenate([rt.rvec, rt.tvec])
            else:
                t_0_b = t_cam_i_0[c].inverse().compose(rt)
                pose0_map[f] = np.concatenate([t_0_b.rvec, t_0_b.tvec])
    if not pose0_map:
        return None
    frame_valid = np.zeros(F)
    poses0 = np.zeros((F, 6))
    for f, p in pose0_map.items():
        frame_valid[f] = 1.0
        poses0[f] = p

    for c in range(C):
        theta0[c] = reduce_params(torch.as_tensor(cameras[c].params), xy_same_focal).numpy()
        lo_c, hi_c = build_bounds(cameras[c], xy_same_focal)
        free_c = disabled_free_mask(cameras[c], xy_same_focal, disabled_distortions)
        theta0[c] = np.where(free_c == 0.0, 0.0, theta0[c])
        lo_c = np.where(free_c == 0.0, -np.inf, lo_c)
        hi_c = np.where(free_c == 0.0, np.inf, hi_c)
        lo[c], hi[c], free[c] = lo_c, hi_c, free_c
        if c > 0:
            ext0[c] = np.concatenate([t_cam_i_0[c].rvec, t_cam_i_0[c].tvec])
        b = batches[c]
        p2d[c, : b.n_frames] = b.p2d
        for f in cam_rtvecs[c]:
            cam_frame_valid[c, f] = 1.0
            w[c, f] = b.mask[f].astype(np.float64)
    if cam0_fixed_focal:
        free[0, 0] = 0.0  # util.rs:664-667

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    args = (
        project_fn(name), t(theta0), t(ext0), t(poses0), t(board.p3d), t(p2d),
        t(w), t(lo), t(hi), t(free), t(cam_frame_valid), t(frame_valid),
    )
    mesh = mesh_for(device)
    if len(mesh) > 1 and F >= len(mesh):
        # frame-sharded joint solve: one reduced system per LM iteration
        sharded = multi_ba_sharded_mixed if mixed else multi_ba_sharded
        res = sharded(*args, one_focal=xy_same_focal, huber_delta=1.0, mesh=mesh)
    else:
        single = ba_solve_multi_mixed if mixed else ba_solve_multi
        res = single(*args, one_focal=xy_same_focal, huber_delta=1.0)
    if not np.isfinite(float(res.cost)):
        return None

    intrinsics = []
    t_i_0_out = []
    ext = res.ext.cpu().numpy()
    for c in range(C):
        m = cameras[c].copy()
        m.set_params(expand_theta(res.theta[c], xy_same_focal).cpu().numpy())
        intrinsics.append(m)
        t_i_0_out.append(
            RvecTvec.identity() if c == 0 else RvecTvec(ext[c, :3], ext[c, 3:])
        )
    poses = res.poses.cpu().numpy()
    board_rtvecs = {
        int(f): RvecTvec(poses[f, :3], poses[f, 3:])
        for f in np.flatnonzero(frame_valid > 0)
    }
    return intrinsics, t_i_0_out, board_rtvecs
