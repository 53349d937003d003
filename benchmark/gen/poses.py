"""Board trajectories and the stereo rig, the benchmark's own (numpy, scipy).

``keyposes`` draws hand-held views of the board's printed side and
``trajectory`` interpolates them into 20 Hz video (slerp for rotation,
smoothstep for translation).  Its parameters (a keyframe every 16 frames,
rotations of 0.3 / 0.3 / 0.5 rad sigma about the board's front, distances
of 0.55 to 1.15 board spans) are assumed, as listed in the configurations'
``assumed``: no frame of the source recordings is at hand to check the
per-frame corner motion against.  ``rig_poses`` moves a trajectory into
another camera of the rig.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp

#: the board's printed side faces a camera looking at it: rot_z(pi)
FRONT = np.array([0.0, 0.0, np.pi])


def keyposes(n: int, p3d: np.ndarray, rng: np.random.Generator, span_scale: float = 1.0):
    """(n, 6) poses (rvec, tvec of the board in the camera's frame)."""
    span = float((p3d[:, :2].max(0) - p3d[:, :2].min(0)).max()) * span_scale
    center = p3d.mean(0)
    base = Rotation.from_rotvec(FRONT)
    out = []
    while len(out) < n:
        pert = rng.normal(size=3) * np.array([0.3, 0.3, 0.5])
        rot = Rotation.from_rotvec(pert) * base
        dist = rng.uniform(0.55, 1.15) * span
        offset = rng.normal(size=2) * 0.25 * span
        R = rot.as_matrix()
        t = np.array([offset[0], offset[1], dist]) - R @ center
        if ((p3d @ R.T + t)[:, 2] <= 0.05 * span).any():
            continue
        out.append(np.concatenate([rot.as_rotvec(), t]))
    return np.stack(out)


def trajectory(n: int, p3d: np.ndarray, seed: int, span_scale: float = 1.0,
               keyframe_every: int = 16):
    """``n`` poses of smooth video from ``seed``."""
    rng = np.random.default_rng(seed)
    n_keys = max(2, -(-n // keyframe_every) + 1)
    keys = keyposes(n_keys, p3d, rng, span_scale)
    slerp = Slerp(np.arange(n_keys, dtype=np.float64), Rotation.from_rotvec(keys[:, :3]))
    out = np.empty((n, 6))
    for f in range(n):
        u = f / keyframe_every
        k = min(int(u), n_keys - 2)
        s = u - k
        s = s * s * (3.0 - 2.0 * s)
        out[f, :3] = slerp(k + s).as_rotvec()
        out[f, 3:] = (1 - s) * keys[k, 3:] + s * keys[k + 1, 3:]
    return out


def rig_extrinsics(n_cams: int, baseline: float):
    """(n_cams, 6) camera i <- camera 0: a horizontal rig of ``baseline``
    metre steps with a slight convergence; row 0 the identity."""
    out = [np.zeros(6)]
    for i in range(1, n_cams):
        out.append(np.array([0.0, -0.02 * i, 0.005 * i, -baseline * i, 0.002 * i, 0.004 * i]))
    return np.stack(out)


def rig_of(config: dict) -> np.ndarray:
    """The rig of a configuration file (its cameras and ``rig_baseline_m``)."""
    return rig_extrinsics(len(config["cameras"]), config.get("rig_baseline_m") or 0.0)


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pose a after pose b, rows of (rvec, tvec)."""
    Ra = Rotation.from_rotvec(a[..., :3])
    R = Ra * Rotation.from_rotvec(b[..., :3])
    return np.concatenate([R.as_rotvec(), Ra.apply(b[..., 3:]) + a[..., 3:]], -1)


def rig_poses(ext_row: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Board poses in camera i's frame from camera 0's, for its ``ext_row``."""
    return compose(np.tile(ext_row, (poses.shape[0], 1)), poses)
