"""AprilGrid board geometry and the t36h11 code table, the benchmark's own.

A board of ``rows x cols`` tags of ``tag_size`` metres with gaps of
``spacing`` tag sizes lies on the z = 0 plane: tag ``t``'s corners are
``t*4 + {0, 1, 2, 3}`` at its top-left, top-right, bottom-right and
bottom-left; columns advance +x, rows advance -y (Kalibr's AprilGrid).
Positions are float32, as a calibration tool reads them from its config.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_CODES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "t36h11_codes.npz")


@dataclasses.dataclass(frozen=True)
class Board:
    rows: int = 6
    cols: int = 6
    tag_size: float = 0.088
    spacing: float = 0.3
    first_id: int = 0

    @property
    def n_tags(self) -> int:
        return self.rows * self.cols

    @property
    def n_corners(self) -> int:
        return 4 * self.n_tags

    def p3d(self) -> np.ndarray:
        """(n_corners, 3) float32 corner positions on the board plane."""
        s = np.float32(self.tag_size)
        pitch = s * np.float32(1.0 + self.spacing)
        r = np.arange(self.rows, dtype=np.float32)
        c = np.arange(self.cols, dtype=np.float32)
        sx = np.broadcast_to(c[None, :] * pitch, (self.rows, self.cols))
        sy = np.broadcast_to(-r[:, None] * pitch, (self.rows, self.cols))
        ox = np.array([0.0, s, s, 0.0], dtype=np.float32)
        oy = np.array([0.0, 0.0, -s, -s], dtype=np.float32)
        x = sx[:, :, None] + ox
        y = sy[:, :, None] + oy
        return np.stack([x, y, np.zeros_like(x)], axis=-1).reshape(self.n_corners, 3)


def board_from_config(cfg: dict) -> Board:
    b = cfg["board"]
    return Board(b["tag_rows"], b["tag_cols"], b["tag_size_meter"], b["tag_spacing"],
                 b.get("first_id", 0))


@dataclasses.dataclass(frozen=True)
class Family:
    """A tag family as printed: ``size`` x ``size`` data cells inside a
    black border of ``border`` cells; ``codes`` (n, size*size) row-major
    bits, 1 = white."""

    codes: np.ndarray
    size: int
    border: int

    @property
    def total_size(self) -> int:
        return self.size + 2 * self.border


def t36h11() -> Family:
    """t36h11 with the 2-cell border of Kalibr's boards (EuRoC, TUM VI)."""
    z = np.load(_CODES)
    return Family(z["codes"], int(z["size"]), 2)
