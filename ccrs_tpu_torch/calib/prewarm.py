"""Warm-up helper: pay the calibration's one-time costs up front.

Port of ``ccrs_tpu/calib/prewarm.py``.  The JAX function loads or compiles
the calibration's device graphs at their real shapes.  Eager torch has no
graph per shape, but a process still pays once, at the first solve: the
first ``torch.func`` forward-mode Jacobian (``vmap(jacfwd)`` of the
reprojection) takes seconds where a warm one takes milliseconds, and the
first ``torch.linalg`` and matmul calls create their library handles
(``tools/first_call_probe.py`` times the pieces; PERF.md has the split).
None of it depends on the problem's size: after a 2-frame solve a
534-frame solve runs at its warm speed.  So ``prewarm_calibration`` solves
dummy problems of a few frames, one per code path the run will take, on a
background thread while the host decodes images.

The Jacobians of every thread run under one lock (``solve/lm.py``): while
the warm-up holds it for its first Jacobian, a solve on another thread
waits, which costs that thread nothing it would not have paid itself.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..board import Board
from ..models import GenericModel, zeros_like_model
from ..types import CalibParams, RvecTvec
from .frames import FrameBatch
from .initialize import try_init_camera
from .single import calib_camera

#: frames of a dummy problem: the one-time costs do not depend on the shape
WARM_FRAMES = 4


def _plausible(model: GenericModel, width: int, height: int) -> GenericModel:
    """``model`` with parameters that keep projections finite when it has
    none yet (a zeros model): a focal of 0.4 x the larger side, the
    principal point at the centre, mild fisheye terms."""
    cam = model.copy()
    cam.set_w_h(width, height)
    p = cam.params.copy()
    if p[0] == 0.0:
        p[0] = p[1] = 0.4 * max(width, height)
        p[2], p[3] = width / 2.0, height / 2.0
        if cam.name in ("ucm", "eucm", "eucmt"):
            p[4] = 0.6
        if cam.name in ("eucm", "eucmt"):
            p[5] = 1.0
        cam.set_params(p)
    return cam


def _dummy_batch(board: Board, cam: GenericModel, n_frames: int):
    """``n_frames`` views of the board through ``cam`` at fixed seeded
    poses (the generator is this function's own): (FrameBatch, poses
    (n_frames, 6))."""
    from ..testdata import default_sequence_poses

    poses = default_sequence_poses(n_frames, board, seed=0)
    p2d = np.zeros((n_frames, board.n_corners, 2))
    mask = np.zeros((n_frames, board.n_corners), bool)
    for f, pose in enumerate(poses):
        p, valid = cam.project(RvecTvec(pose[:3], pose[3:]).transform(board.p3d))
        inside = (p[:, 0] >= 0) & (p[:, 0] < cam.width) & (p[:, 1] >= 0) & (p[:, 1] < cam.height)
        mask[f] = valid & inside
        p2d[f] = np.where(mask[f][:, None], p, 0.0)
    times = np.arange(1, n_frames + 1, dtype=np.int64)
    return FrameBatch(times, p2d, mask, int(cam.width), int(cam.height)), poses


def prewarm_calibration(
    board: Board,
    n_frames: int,
    target_model: Union[GenericModel, str],
    calib_params: Optional[CalibParams] = None,
    width: int = 512,
    height: int = 512,
    speculative: bool = False,
    n_frames_spec: Optional[int] = None,
    device="cuda",
    solver: str = "f64",
) -> None:
    """Run the init attempt and the single-camera solve once each on dummy
    data, on ``device``, so that the first real solve finds the process
    warm.  Safe to skip or to run beside detection: the first real solve
    simply pays the costs itself if this has not finished.

    One ``try_init_camera`` attempt on two frames, then one ``calib_camera``
    per variant of the run: the cold final solve (PnP pose init); with
    ``speculative`` also the ``skip_pose_init`` warm-path final solve and
    the speculation's seed solve (float32 PnP, ``polish_iters=2``).
    ``n_frames`` / ``n_frames_spec`` (the frames the final solve and the
    speculation will see) are kept for the JAX signature: every dummy
    problem has ``min(n, WARM_FRAMES)`` frames (see the module docstring).
    ``solver``: the route to warm, as the run will call ``calib_camera``.

    The dummy data come from generators of this function's own (numpy and
    torch, seeded 0): the caller's generators, the speculation's and
    torch's global one are not touched.
    """
    if calib_params is None:
        calib_params = CalibParams()
    if isinstance(target_model, str):
        target_model = zeros_like_model(target_model)
    cam = _plausible(target_model, width, height)
    n_spec = n_frames if n_frames_spec is None else n_frames_spec
    F = max(2, min(max(n_frames, n_spec), WARM_FRAMES))
    batch, poses = _dummy_batch(board, cam, F)

    generator = torch.Generator(device=device).manual_seed(0)
    try_init_camera(
        board, batch, 0, 1, generator, calib_params.fixed_focal, device=device,
        solver=solver,
    )

    one_focal = calib_params.one_focal or calib_params.fixed_focal is not None
    # (polish_iters, skip_pose_init, pose_init_f32): the cold final solve
    # always; the warm-path final and the float32-PnP seed solve only
    # exist when the caller speculates
    variants = [(12, False, False)]
    if speculative:
        variants += [(12, True, False), (2, False, True)]
    for polish_iters, skip, p32 in variants:
        calib_camera(
            board, batch, cam, one_focal, calib_params.disabled_distortion_num,
            False,
            warm_poses=poses if skip else None,
            warm_valid=np.ones(F) if skip else None,
            polish_iters=polish_iters, skip_pose_init=skip, pose_init_f32=p32,
            device=device, solver=solver,
        )
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
