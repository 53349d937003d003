"""Cold AprilGrid detection of the PyTorch port against the JAX package on
rendered 512x512 and 1024x1024 frames (the same uint8 arrays into both;
1024 runs the scale-2 pyramid branch): tag ids,
rotations and validity exact; corners within 1e-3 px (float32 sampling and
12 Newton steps, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import decode as JD
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect import decode as TD
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import gt_corners, render_frames_device, smooth_sequence_poses

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px


def _render(size, n_frames):
    """n_frames of a smooth size x size sequence with sensor noise, uint8."""
    board = create_default_6x6_board()
    s = size / 512.0
    gt = GenericModel("eucm", [p * s for p in GT[:4]] + GT[4:], size, size)
    poses = smooth_sequence_poses(8 * n_frames, board, seed=5)[::8]
    imgs = render_frames_device(
        gt, board, get_family("t36h11"), poses, noise=1.5,
        generator=torch.Generator().manual_seed(5),
    ).numpy()
    return imgs, poses, gt


@pytest.fixture(scope="module")
def frames():
    return _render(512, 6)


def test_refine_decode_matches_on_same_quads(frames):
    """Same perturbed ground-truth quads into both refine+decode paths."""
    imgs, poses, gt = frames
    board = create_default_6x6_board()
    rng = np.random.default_rng(0)
    quads = np.zeros((len(imgs), board.n_tags, 4, 2), np.float32)
    qvalid = np.zeros((len(imgs), board.n_tags), bool)
    for f, pose in enumerate(poses):
        p2d, vis = gt_corners(gt, board, pose[:3], pose[3:])
        q = p2d.reshape(board.n_tags, 4, 2)[:, [1, 0, 3, 2]]  # clockwise
        quads[f] = q + rng.normal(size=q.shape) * 0.8
        qvalid[f] = vis.reshape(board.n_tags, 4).all(axis=1)
    want = JD.refine_decode_fused_dense(
        jax_family("t36h11"), jnp.asarray(imgs), jnp.asarray(quads),
        jnp.asarray(qvalid),
    )
    got = TD.refine_decode_fused_dense(
        get_family("t36h11"), torch.as_tensor(imgs), torch.as_tensor(quads),
        torch.as_tensor(qvalid),
    )
    for k in ("tag_id", "rotation", "hamming", "valid", "contrast_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() > 0.8 * qvalid.sum()
    np.testing.assert_allclose(
        got["corners"].numpy(), np.asarray(want["corners"]), rtol=0, atol=CORNER_TOL
    )


@pytest.mark.parametrize("size", [512, 1024])
def test_cold_detector_matches(frames, size):
    imgs = frames[0] if size == 512 else _render(1024, 2)[0]
    want = JaxDetector("t36h11", track=False).detect_batch(imgs, board=jax_board())
    got = TagDetector("t36h11", track=False).detect_batch(
        imgs, board=create_default_6x6_board()
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert len(g) >= 28
        for t in g:
            np.testing.assert_allclose(g[t], w[t], rtol=0, atol=CORNER_TOL)


def test_single_image_detect_without_board(frames):
    imgs, _, _ = frames
    want = JaxDetector("t36h11", track=False).detect(imgs[0])
    got = TagDetector("t36h11").detect(imgs[0])
    assert sorted(got) == sorted(want)


def test_tracking_not_ported(monkeypatch):
    """The tracking switch: on by default, off with CCRS_TRACK=0, and an
    explicit ``track`` wins; a tracking detector opens a streaming session
    only when given a board."""
    monkeypatch.delenv("CCRS_TRACK", raising=False)
    assert TagDetector("t36h11").track
    assert TagDetector("t36h11", track=True).begin_tracked(None) is None
    assert TagDetector("t36h11", track=False).begin_tracked(create_default_6x6_board()) is None
    monkeypatch.setenv("CCRS_TRACK", "0")
    assert not TagDetector("t36h11").track
    assert TagDetector("t36h11", track=True).track
