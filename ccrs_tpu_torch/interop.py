"""Carry state from the JAX package's objects into the port's.

The system has no trained weights; its state is the board geometry, the
tag-family code table (read from the same file by both packages), the
camera parameters and the observations.  These helpers read the JAX
package's ``GenericModel``, ``Board``, ``FrameBatch`` and ``RvecTvec``
through their numpy attributes and build the port's objects, so both
packages compute from identical state.  Nothing here imports jax: any
object with the same attributes converts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .board import Board, BoardConfig
from .calib.frames import FrameBatch
from .detect.track import carry_to_device
from .models import GenericModel
from .types import RvecTvec


def model_from_ref(model) -> GenericModel:
    """GenericModel from an object with ``name``, ``params``, ``width``,
    ``height``."""
    return GenericModel(
        model.name, np.asarray(model.params, np.float64), model.width, model.height
    )


def board_from_ref(board) -> Board:
    """Board from an object whose ``config`` is a BoardConfig-like
    dataclass; the port rebuilds ``p3d`` and checks it equals the
    reference's."""
    cfg = BoardConfig(**dataclasses.asdict(board.config))
    out = Board(cfg)
    if not np.array_equal(out.p3d, np.asarray(board.p3d)):
        raise ValueError("board geometry differs from the reference's p3d")
    return out


def frame_batch_from_ref(batch) -> FrameBatch:
    """FrameBatch from an object with the FrameBatch arrays."""
    return FrameBatch(
        np.asarray(batch.time_ns, np.int64),
        np.asarray(batch.p2d, np.float64),
        np.asarray(batch.mask, bool),
        int(batch.width),
        int(batch.height),
    )


def wave_carry_from_ref(carry, device="cpu"):
    """The port's wave carry (track.wave_advance) from the JAX package's:
    any 9-sequence of arrays (c3, v3, c2, v2, c1, v1, coast_c, coast_v,
    coast_age) becomes tensors on ``device`` with the same dtypes
    (float32 corners, bool validity, int32 coast age)."""
    dtypes = (np.float32, bool, np.float32, bool, np.float32, bool,
              np.float32, np.float32, np.int32)
    if len(carry) != len(dtypes):
        raise ValueError(f"a wave carry has {len(dtypes)} arrays, got {len(carry)}")
    return carry_to_device([np.asarray(a, dt) for a, dt in zip(carry, dtypes)], device)


def rvectvec_from_ref(rt) -> RvecTvec:
    """RvecTvec from an object with ``rvec`` and ``tvec``."""
    return RvecTvec(np.asarray(rt.rvec, np.float64), np.asarray(rt.tvec, np.float64))
