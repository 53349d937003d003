"""Detections as a detection cache holds them, drawn from a seed without
rendering: the observation model of the joint-BA benchmark of the
8-camera rig (numpy draws, float64 geometry).

The board's printed side faces camera 0 under a rotation perturbed by
``rot_sigma`` rad per axis at ``distance_m`` metres; camera c sees it
through the rig.  A corner is observed where it projects inside the
image; each observation gets Gaussian noise of ``noise_px`` per axis; a
camera past the first sees a frame with probability ``visible_share``;
a frame counts for a camera with at least ``min_corners`` corners.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera
from .poses import FRONT, compose, rig_poses


def observe(params, width: int, height: int, p3d: np.ndarray, ext: np.ndarray,
            n_frames: int, pose_seed: int, noise_seed: int, rot_sigma: float, distance_m,
            noise_px: float, visible_share: float, min_corners: int):
    """Returns (poses (F, 6) of the board in camera 0, p2d (C, F, N, 2),
    mask (C, F, N) bool); ``params`` (C, 6).  The poses are drawn from
    ``pose_seed``, the noise and the visibility from ``noise_seed``."""
    rng = np.random.default_rng(pose_seed)
    C, F, N = ext.shape[0], n_frames, p3d.shape[0]
    perts = rng.normal(size=(F, 3)) * rot_sigma
    dists = rng.uniform(distance_m[0], distance_m[1], F)
    zeros = np.zeros((F, 3))
    rot = compose(np.concatenate([perts, zeros], 1),
                  np.concatenate([np.tile(FRONT, (F, 1)), zeros], 1))[:, :3]
    R = torch.as_tensor(rot, dtype=torch.float64)
    Rm = camera.rotation(R).numpy()
    tv = np.stack([zeros[:, 0], zeros[:, 0], dists], 1) - Rm @ p3d.astype(np.float64).mean(0)
    poses = np.concatenate([rot, tv], 1)
    rng = np.random.default_rng(noise_seed)
    p2d = np.zeros((C, F, N, 2))
    mask = np.zeros((C, F, N), bool)
    pts = torch.as_tensor(p3d, dtype=torch.float64)
    for c in range(C):
        pc = rig_poses(ext[c], poses) if c else poses
        pc_t = torch.as_tensor(pc, dtype=torch.float64)
        pr, valid = camera.project(torch.as_tensor(np.asarray(params[c], np.float64)),
                                   camera.transform(pc_t[:, :3], pc_t[:, 3:], pts))
        pr = pr.numpy()
        inside = (valid.numpy() & (pr[..., 0] >= 0) & (pr[..., 0] < width)
                  & (pr[..., 1] >= 0) & (pr[..., 1] < height))
        p2d[c] = np.where(inside[..., None], pr + rng.normal(size=(F, N, 2)) * noise_px, 0.0)
        seen = np.ones(F, bool) if c == 0 else rng.uniform(size=F) < visible_share
        m = inside & seen[:, None]
        m &= (m.sum(1) >= min_corners)[:, None]
        mask[c] = m
    return poses, p2d, mask
