"""Edge cases of detection through both packages on the CPU.

The scenes of ``tests/test_edge_cases.py`` (a 643 x 481 OPENCV5 frame that
takes both padding paths, pure noise, a 1 x 1 board) and the input dtypes
the detectors accept (uint16, RGB, RGBA, float 0..1, float 0..255): the
same numpy frame goes into ``ccrs_tpu``'s and the port's ``TagDetector``.
Tag ids are equal and corners agree within 1e-3 px (measured: 1.3e-4), for
the default tracked detector and the cold one.
"""

import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu_torch.board import Board, BoardConfig, create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.interop import board_from_ref
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.solve import se3
from ccrs_tpu_torch.testdata import (
    default_sequence_poses,
    front_view_base,
    gt_corners,
    render_board_image,
)
from torch_jax_pin import assert_same_detections, fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

CORNER_TOL = 1e-3  # px
EUCM = ("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)


def detect_both(img, track=True):
    """One frame through both detectors: the port's detections, after
    holding them against the JAX package's."""
    want = JaxDetector("t36h11", track=track).detect(img)
    got = TagDetector("t36h11", track=track, device="cpu").detect(img)
    assert_same_detections([got], [want], CORNER_TOL)
    return got


def odd_size_frame():
    """643 x 481: the tile pad (H) and the bit-pack pad (W) both apply."""
    board = create_default_6x6_board()
    m = GenericModel("opencv5", [420, 420, 321.5, 240.5, -0.1, 0.02, 0, 0, 0], 643, 481)
    zero = torch.zeros(3, dtype=torch.float64)
    rv, _ = se3.compose(torch.tensor([0.1, -0.08, 0.05], dtype=torch.float64), zero,
                        torch.as_tensor(front_view_base()), zero)
    rvec = rv.numpy()
    tvec = np.array([0.0, 0.0, 0.85]) - se3.exp_so3(rv).numpy() @ board.p3d.mean(0)
    img = render_board_image(m, board, get_family("t36h11"), rvec, tvec)
    return m, board, rvec, tvec, img


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "cold"])
def test_odd_image_size_padding_path(track):
    m, board, rvec, tvec, img = odd_size_frame()
    assert img.shape == (481, 643)
    tags = detect_both(img, track)
    assert len(tags) >= 25
    p2d, vis = gt_corners(m, board, rvec, tvec)
    errs = [np.linalg.norm(cs[c] - p2d[tid * 4 + c])
            for tid, cs in tags.items() for c in range(4) if vis[tid * 4 + c]]
    assert np.mean(errs) < 0.3


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "cold"])
def test_pure_noise_image(track):
    img = np.random.default_rng(0).integers(0, 255, (480, 640), np.uint8)
    assert len(detect_both(img, track)) <= 2  # noise must not hallucinate a board


def test_single_tag_board():
    """A 1 x 1 board (first id 7): detection, and with the board given the
    corner assist, agree in both packages."""
    board = Board(BoardConfig(tag_rows=1, tag_cols=1, first_id=7))
    assert board.n_corners == 4
    m = GenericModel("opencv5", [400, 400, 256, 256, 0, 0, 0, 0, 0], 512, 512)
    img = render_board_image(m, board, get_family("t36h11"), np.array([0.0, 0.0, np.pi]),
                             np.array([0.044, 0.044, 0.25]))
    assert 7 in detect_both(img)
    from ccrs_tpu.board import Board as JaxBoard
    from ccrs_tpu.board import BoardConfig as JaxBoardConfig

    jb = JaxBoard(JaxBoardConfig(tag_rows=1, tag_cols=1, first_id=7))
    want = JaxDetector("t36h11", track=False).detect_batch(img[None], board=jb)
    got = TagDetector("t36h11", track=False, device="cpu").detect_batch(
        img[None], board=board_from_ref(jb))
    assert_same_detections(got, want, CORNER_TOL)
    assert 7 in got[0]


def dtype_frame():
    """A tilted view of the whole board with a little noise.  (The frame of
    ``tests/test_edge_cases.py::test_uint16_input_full_path``, seed 13,
    shows no decodable tag, so its comparison holds for any detector.)"""
    board = create_default_6x6_board()
    pose = default_sequence_poses(6, board, seed=5)[3]
    return render_board_image(GenericModel(*EUCM), board, get_family("t36h11"),
                              pose[:3], pose[3:], noise=1.0, seed=2)


def as_dtype(img8, kind):
    rgb = np.stack([img8, img8 // 2 + 60, 255 - (255 - img8) // 3], axis=-1)
    return {
        "uint8": img8,
        "uint16": (img8.astype(np.uint16) * 257).astype(np.uint16),
        "uint16_12bit": (img8.astype(np.uint16) << 4) + 9,  # a 12-bit sensor's range
        "rgb": rgb,
        "rgba": np.concatenate([rgb, np.full(img8.shape + (1,), 255, np.uint8)], axis=-1),
        "float01": img8.astype(np.float32) / 255.0,
        "float255": img8.astype(np.float32),
        "float64_255": img8.astype(np.float64) + 0.25,
    }[kind]


@pytest.mark.parametrize(
    "kind", ["uint8", "uint16", "uint16_12bit", "rgb", "rgba", "float01", "float255",
             "float64_255"])
def test_input_dtypes(kind):
    """Every input format goes through the same gray conversion in both
    packages; uint16 keeps at least 90% of the 8-bit frame's tags."""
    img8 = dtype_frame()
    tags = detect_both(as_dtype(img8, kind))
    n8 = len(TagDetector("t36h11", device="cpu").detect(img8))
    assert n8 >= 20
    if kind != "uint16_12bit":  # 0..4095 is a sixteenth of the 16-bit range: low contrast
        assert len(tags) >= 0.9 * n8


def test_batch_of_mixed_scenes_with_board():
    """The odd-size frame twice in one batch with the board given (the
    assist path), tracked and cold in one go."""
    _, board, _, _, img = odd_size_frame()
    imgs = np.stack([img, img[::-1, ::-1].copy()])
    for track in (True, False):
        want = JaxDetector("t36h11", track=track).detect_batch(imgs, board=jax_board())
        got = TagDetector("t36h11", track=track, device="cpu").detect_batch(imgs, board=board)
        assert_same_detections(got, want, CORNER_TOL)
        assert len(got[0]) >= 25
