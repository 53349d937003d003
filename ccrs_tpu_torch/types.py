"""Core pose/parameter types (copy of ``ccrs_tpu/types.py``; numpy only).

Host-side counterpart of the reference types (``src/types.rs``):
``RvecTvec`` (axis-angle rotation + translation, JSON-serializable with the
same schema), ``Extrinsics``, and ``CalibParams``.  Device-side SE(3) math
lives in ``ccrs_tpu_torch.solve.se3`` as torch functions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (float64)."""
    r = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        K = _hat(r)
        return np.eye(3) + K  # first-order for tiny angles
    k = r / theta
    K = _hat(k)
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _hat(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]],
        dtype=np.float64,
    )


def rotation_to_rvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (float64); inverse of :func:`rodrigues`."""
    R = np.asarray(R, dtype=np.float64)
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_theta))
    if theta < 1e-12:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return 0.5 * w
    if abs(np.pi - theta) < 1e-7:
        # near pi: use the symmetric part
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(A), 0.0))
        # fix signs from off-diagonals
        i = int(np.argmax(axis))
        if axis[i] > 0:
            axis = A[i] / axis[i]
            n = np.linalg.norm(axis)
            if n > 0:
                axis = axis / n
        return axis * theta
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (theta / (2.0 * np.sin(theta)))


@dataclasses.dataclass
class RvecTvec:
    """Axis-angle + translation pose T (maps board/world points into camera).

    JSON schema matches the reference serde output
    (``src/types.rs:13-36``): ``{"rvec": [x,y,z], "tvec": [x,y,z]}``.
    """

    rvec: np.ndarray  # (3,) float64
    tvec: np.ndarray  # (3,) float64

    def __init__(self, rvec, tvec):
        self.rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
        self.tvec = np.asarray(tvec, dtype=np.float64).reshape(3)

    def to_matrix(self) -> np.ndarray:
        """4x4 homogeneous transform."""
        T = np.eye(4)
        T[:3, :3] = rodrigues(self.rvec)
        T[:3, 3] = self.tvec
        return T

    @staticmethod
    def from_matrix(T: np.ndarray) -> "RvecTvec":
        return RvecTvec(rotation_to_rvec(T[:3, :3]), np.asarray(T[:3, 3]))

    def inverse(self) -> "RvecTvec":
        T = self.to_matrix()
        Ti = np.eye(4)
        Ti[:3, :3] = T[:3, :3].T
        Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
        return RvecTvec.from_matrix(Ti)

    def compose(self, other: "RvecTvec") -> "RvecTvec":
        """self * other (apply ``other`` first)."""
        return RvecTvec.from_matrix(self.to_matrix() @ other.to_matrix())

    def transform(self, p3d: np.ndarray) -> np.ndarray:
        """Apply to (N,3) points."""
        R = rodrigues(self.rvec)
        return np.asarray(p3d, dtype=np.float64) @ R.T + self.tvec

    def to_json(self) -> dict:
        return {"rvec": list(map(float, self.rvec)), "tvec": list(map(float, self.tvec))}

    @staticmethod
    def from_json(obj: dict) -> "RvecTvec":
        return RvecTvec(np.array(obj["rvec"]), np.array(obj["tvec"]))

    @staticmethod
    def identity() -> "RvecTvec":
        return RvecTvec(np.zeros(3), np.zeros(3))


@dataclasses.dataclass
class Extrinsics:
    """Per-camera poses relative to cam0 (``src/types.rs:41-52``)."""

    rtvecs: list

    def to_json(self) -> dict:
        return {"rtvecs": [rt.to_json() for rt in self.rtvecs]}

    @staticmethod
    def from_json(obj: dict) -> "Extrinsics":
        return Extrinsics([RvecTvec.from_json(o) for o in obj["rtvecs"]])


@dataclasses.dataclass
class CalibParams:
    """Calibration options (``src/types.rs:6-10``)."""

    fixed_focal: Optional[float] = None
    disabled_distortion_num: int = 0
    one_focal: bool = False
