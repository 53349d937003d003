"""Dense frame-feature batches: the detector -> optimizer contract
(copy of ``ccrs_tpu/calib/frames.py``, plus a stage timer; the arrays are
numpy, the timer is ``utils.profiling``, which imports torch).

Replacement for the reference's
``FrameFeature { time_ns, img_w_h, features: HashMap<corner_id, (p2d,p3d)> }``
(``src/detected_points.rs:5-17``): a camera's whole sequence is ONE
structure-of-arrays batch, indexed by board corner id, so every downstream
stage is a fixed-shape masked tensor op.

- ``p2d[f, c]``: observed pixel of board corner ``c`` in frame ``f``
- ``mask[f, c]``: corner observed (the HashMap key set)
- a frame that failed detection (reference ``None``) is simply an all-false
  mask row; ``MIN_CORNERS`` filtering (src/data_loader.rs:15,61) is a
  mask-count predicate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..board import Board
from ..utils.profiling import stage

MIN_CORNERS = 24  # src/data_loader.rs:15


@dataclasses.dataclass
class FrameBatch:
    """All detections of one camera over a sequence."""

    time_ns: np.ndarray  # (F,) int64
    p2d: np.ndarray  # (F, N, 2) float64, undefined where ~mask
    mask: np.ndarray  # (F, N) bool
    width: int
    height: int

    @property
    def n_frames(self) -> int:
        return self.p2d.shape[0]

    @property
    def n_corners(self) -> int:
        return self.p2d.shape[1]

    def counts(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    def frame_ok(self, min_corners: int = MIN_CORNERS) -> np.ndarray:
        """Frames passing the detection threshold (reference Some(...))."""
        return self.counts() >= min_corners

    def truncate(self, max_frames: int) -> "FrameBatch":
        return FrameBatch(
            self.time_ns[:max_frames],
            self.p2d[:max_frames],
            self.mask[:max_frames],
            self.width,
            self.height,
        )

    def save(self, path: str) -> None:
        """Persist detections (the optional re-detect cache, SURVEY.md §5
        checkpoint/resume)."""
        np.savez_compressed(
            path, time_ns=self.time_ns, p2d=self.p2d, mask=self.mask,
            width=self.width, height=self.height,
        )

    @staticmethod
    def load(path: str) -> "FrameBatch":
        z = np.load(path)
        return FrameBatch(
            z["time_ns"], z["p2d"], z["mask"], int(z["width"]), int(z["height"])
        )

    @staticmethod
    def from_detections(
        detections: list, times_ns: list, board: Board, width: int, height: int,
        min_corners: int = MIN_CORNERS,
    ) -> "FrameBatch":
        """Build from per-frame {tag_id: [(x,y) x4]} dicts (detector output).

        Corner id = tag_id*4 + corner (src/data_loader.rs:49); ids outside
        the board are dropped; frames with < min_corners get an all-false
        row (the reference's None frames).  Runs as the stage
        ``calib/frames``.
        """
        F = len(detections)
        N = board.n_corners
        p2d = np.zeros((F, N, 2), np.float64)
        mask = np.zeros((F, N), bool)
        with stage("calib/frames"):
            for f, det in enumerate(detections):
                for tag_id, corners in det.items():
                    for c in range(4):
                        cid = int(tag_id) * 4 + c
                        idx = cid - board.first_corner_id
                        if 0 <= idx < N:
                            p2d[f, idx] = corners[c]
                            mask[f, idx] = True
                if mask[f].sum() < min_corners:
                    mask[f] = False
        return FrameBatch(np.asarray(times_ns, np.int64), p2d, mask, width, height)
