"""Framework-free modules copied into the PyTorch port (board, families,
frames, io) against the JAX package's: board geometry and tag codes
identical, JSON and report.txt byte-identical."""

import os

import numpy as np
import pytest
import torch

from ccrs_tpu import io as jio
from ccrs_tpu.board import Board as JaxBoard, BoardConfig as JaxBoardConfig
from ccrs_tpu.calib.frames import FrameBatch as JaxFrameBatch
from ccrs_tpu.detect.families import FAMILY_NAMES as JAX_FAMILIES
from ccrs_tpu.detect.families import get_family as jax_family
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu_torch import io as tio
from ccrs_tpu_torch.board import Board, BoardConfig
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.detect.families import FAMILY_NAMES, get_family
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.types import RvecTvec

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "cfg",
    [{}, {"tag_size_meter": 0.05, "tag_spacing": 0.25, "tag_rows": 4,
          "tag_cols": 7, "first_id": 3}],
)
def test_board_geometry_matches(cfg):
    jb, tb = JaxBoard(JaxBoardConfig(**cfg)), Board(BoardConfig(**cfg))
    np.testing.assert_array_equal(tb.p3d, jb.p3d)
    assert (tb.n_tags, tb.n_corners, tb.first_corner_id) == (
        jb.n_tags, jb.n_corners, jb.first_corner_id
    )
    assert tb.config.to_json() == jb.config.to_json()


def test_family_tables_match():
    assert tuple(FAMILY_NAMES) == tuple(JAX_FAMILIES)
    for name in FAMILY_NAMES:
        t, j = get_family(name), jax_family(name)
        np.testing.assert_array_equal(t.codes, j.codes)
        np.testing.assert_array_equal(t.rotated_codes, j.rotated_codes)
        assert (t.size, t.border, t.total_size, t.max_hamming) == (
            j.size, j.border, j.total_size, j.max_hamming
        )


def test_frame_batch_from_detections_matches():
    rng = np.random.default_rng(0)
    dets = [
        {int(t): rng.uniform(0, 512, (4, 2)).astype(np.float32)
         for t in rng.choice(40, size=n, replace=False)}
        for n in (0, 5, 30, 36)
    ]
    times = [10, 20, 30, 40]
    tb = FrameBatch.from_detections(dets, times, Board(BoardConfig()), 512, 512)
    jb = JaxFrameBatch.from_detections(dets, times, JaxBoard(JaxBoardConfig()), 512, 512)
    np.testing.assert_array_equal(tb.p2d, jb.p2d)
    np.testing.assert_array_equal(tb.mask, jb.mask)
    np.testing.assert_array_equal(tb.time_ns, jb.time_ns)


def test_report_and_json_bytes_match(tmp_path):
    rep = [(0.0812345, 0.0765432), (0.1, 0.2)]
    for with_ext in (False, True):
        jio.write_report(tmp_path / "j.txt", with_ext, rep)
        tio.write_report(tmp_path / "t.txt", with_ext, rep)
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    params = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
    jio.object_to_json(tmp_path / "j.json", JaxModel("eucm", params, 512, 512))
    tio.object_to_json(tmp_path / "t.json", GenericModel("eucm", params, 512, 512))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    pose = RvecTvec([0.1, -0.2, 3.0], [0.05, 0.0, 0.6])
    tio.object_to_json(tmp_path / "p.json", pose)
    assert tio.object_from_json(tmp_path / "p.json") == pose.to_json()
    assert os.path.getsize(tmp_path / "p.json") > 0
