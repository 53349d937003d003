"""Wave-tracked detection of the PyTorch port against the JAX package's on
the CPU: the same uint8 frames into both packages' default detectors
(tracking on).  Per frame the tag ids are exact and the corners within
1e-3 px, and the detector stats (cold frames, sweeps, audits, waves,
resweeps and the audit trigger log) are equal.  Two sequences, the
fixtures of tests/test_track.py: 14 noisy frames that audit and resweep,
and 48 frames of the bench's smooth-video regime.  Also a shuffled (not
video) sequence, where every frame falls back to cold."""

import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.testdata import render_board_image, render_frames_device, smooth_sequence_poses
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.interop import board_from_ref

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px


def video_frames():
    """The 14-frame smooth sequence of tests/test_track.py (512x512 EUCM)."""
    board = jax_board()
    fam = jax_family("t36h11")
    model = JaxModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(14, board, seed=3, keyframe_every=6)
    return np.stack([
        render_board_image(model, board, fam, p[:3], p[3:], noise=1.5, seed=f)
        for f, p in enumerate(poses)
    ])


def bench_like_frames():
    """48 frames of the bench's smooth-video regime (tests/test_track.py)."""
    board = jax_board()
    poses = smooth_sequence_poses(48, board, seed=11)
    return np.asarray(
        render_frames_device(JaxModel("eucm", GT, 512, 512), board,
                             jax_family("t36h11"), poses, noise=1.5, seed=11)
    ).astype(np.uint8)


def assert_same_detections(got, want):
    assert len(got) == len(want)
    for f, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"frame {f}: {set(g) ^ set(w)}"
        for t in g:
            np.testing.assert_allclose(g[t], w[t], rtol=0, atol=CORNER_TOL)


def run_both(imgs):
    jb = jax_board()
    jdet = JaxDetector("t36h11", track=True)
    want = jdet.detect_batch(imgs, board=jb)
    det = TagDetector("t36h11", device="cpu")
    assert det.track  # the default
    got = det.detect_batch(imgs, board=board_from_ref(jb))
    return got, want, det.stats, jdet.stats


@pytest.mark.parametrize("name", ["video", "bench_like", "shuffled"])
def test_tracked_matches_reference(name):
    if name == "bench_like":
        imgs = bench_like_frames()
    else:
        imgs = video_frames()
        if name == "shuffled":
            imgs = imgs[[5, 0, 9, 2, 12, 7]]
    got, want, stats, jstats = run_both(imgs)
    assert_same_detections(got, want)
    assert stats == jstats
    if name == "video":
        # the fixture exercises the audits and a repair resweep
        assert stats["trigger_frames"] > 0 and stats.get("resweeps", 0) > 0
    if name == "bench_like":
        assert stats["waves"] > 0 and stats["cold_frames"] <= len(imgs) // 3
