"""AprilGrid board geometry (copy of ``ccrs_tpu/board.py``; numpy only).

Counterpart of the reference board model (``src/board.rs:7-101``): instead
of a ``HashMap<u32, Vec3>`` from corner id to 3D point, the board is a
dense ``(n_corners, 3)`` array indexed by ``corner_id - first_id*4``.  Dense
indexing lets every downstream stage (decode, PnP, bundle adjustment) run
as batched tensor ops with validity masks instead of hash lookups.

Corner layout per tag (reference ``src/board.rs:46-95``): for tag ``t`` the
corner ids are ``t*4 + {0, 1, 2, 3}`` at top-left, top-right, bottom-right,
bottom-left of the tag; columns advance +x, rows advance -y, z = 0.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class BoardConfig:
    """Board configuration; JSON schema identical to the reference
    (``src/board.rs:7-25``, ``data/default_board_config.json``)."""

    tag_size_meter: float = 0.088
    tag_spacing: float = 0.3
    tag_rows: int = 6
    tag_cols: int = 6
    first_id: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "BoardConfig":
        return BoardConfig(**obj)

    @staticmethod
    def from_file(path: str) -> "BoardConfig":
        with open(path) as f:
            return BoardConfig.from_json(json.load(f))


class Board:
    """Dense AprilGrid board: 3D corner positions on the z=0 plane.

    Attributes:
      config: the BoardConfig.
      n_tags: tag_rows * tag_cols.
      n_corners: n_tags * 4.
      first_corner_id: first_id * 4; corner id ``cid`` maps to row
        ``cid - first_corner_id`` of ``p3d``.
      p3d: float32 (n_corners, 3) board-frame corner positions.
    """

    def __init__(self, config: BoardConfig):
        self.config = config
        self.n_tags = config.tag_rows * config.tag_cols
        self.n_corners = self.n_tags * 4
        self.first_corner_id = config.first_id * 4
        s = np.float32(config.tag_size_meter)
        pitch = s * np.float32(1.0 + config.tag_spacing)

        r = np.arange(config.tag_rows, dtype=np.float32)
        c = np.arange(config.tag_cols, dtype=np.float32)
        start_x = (c[None, :] * pitch)  # (1, cols)
        start_y = (-r[:, None] * pitch)  # (rows, 1)
        sx = np.broadcast_to(start_x, (config.tag_rows, config.tag_cols))
        sy = np.broadcast_to(start_y, (config.tag_rows, config.tag_cols))
        # corner offsets TL, TR, BR, BL (src/board.rs:57-91)
        ox = np.array([0.0, s, s, 0.0], dtype=np.float32)
        oy = np.array([0.0, 0.0, -s, -s], dtype=np.float32)
        x = sx[:, :, None] + ox[None, None, :]
        y = sy[:, :, None] + oy[None, None, :]
        z = np.zeros_like(x)
        self.p3d = np.stack([x, y, z], axis=-1).reshape(self.n_corners, 3)

    @staticmethod
    def from_config(config: BoardConfig) -> "Board":
        return Board(config)

    def corner_index(self, corner_id: np.ndarray) -> np.ndarray:
        """Map detector corner ids (tag_id*4 + corner) to rows of ``p3d``.

        Returns -1 for ids outside the board (caller masks those out),
        mirroring the reference's failed ``id_to_3d`` lookups
        (``src/data_loader.rs:49-57``).
        """
        idx = np.asarray(corner_id, dtype=np.int64) - self.first_corner_id
        valid = (idx >= 0) & (idx < self.n_corners)
        return np.where(valid, idx, -1)


def create_default_6x6_board() -> Board:
    """Default 6x6 grid, 0.088 m tags, 0.3 spacing (``src/board.rs:99-101``)."""
    return Board(BoardConfig())
