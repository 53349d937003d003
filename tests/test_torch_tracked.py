"""Wave-tracked detection of the PyTorch port against the JAX package's on
the CPU: the same uint8 frames into both packages' default detectors
(tracking on).  Per frame the tag ids are exact and the corners within
1e-3 px, and the detector stats (cold frames, sweeps, audits, waves,
resweeps and the audit trigger log) are equal.  Two sequences, the
fixtures of tests/test_track.py: 14 noisy frames that audit and resweep,
and 48 frames of the bench's smooth-video regime.  Also a shuffled (not
video) sequence, where every frame falls back to cold.

The JAX side runs on fresh jit traces (``jax.clear_caches()`` before each
run, for the reason ``tests/torch_jax_pin.py`` gives): the
``video_after_tpu_traces`` case leaves TPU-formulation traces behind first.  A
failure names the frame, tag or stat that differed, with the state a test
process can leave behind: torch's thread count and the ``CCRS_*``
environment in force."""

import os

import jax
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.testdata import render_board_image, render_frames_device, smooth_sequence_poses
from ccrs_tpu_torch import testdata as port_testdata
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.detect import get_family as port_family
from ccrs_tpu_torch.interop import board_from_ref, model_from_ref

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px


def video_frames():
    """The 14-frame smooth sequence of tests/test_track.py (512x512 EUCM),
    rendered by each package's own ``render_board_image`` for its own
    detector: (JAX frames, port frames).  The two are equal pixel for pixel
    (tests/test_torch_testdata.py holds that)."""
    board = jax_board()
    fam = jax_family("t36h11")
    model = JaxModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(14, board, seed=3, keyframe_every=6)
    ref = np.stack([
        render_board_image(model, board, fam, p[:3], p[3:], noise=1.5, seed=f)
        for f, p in enumerate(poses)
    ])
    pboard, pfam, pmodel = board_from_ref(board), port_family("t36h11"), model_from_ref(model)
    port = np.stack([
        port_testdata.render_board_image(pmodel, pboard, pfam, p[:3], p[3:], noise=1.5, seed=f)
        for f, p in enumerate(poses)
    ])
    return ref, port


def bench_like_frames():
    """48 frames of the bench's smooth-video regime (tests/test_track.py)."""
    board = jax_board()
    poses = smooth_sequence_poses(48, board, seed=11)
    return np.asarray(
        render_frames_device(JaxModel("eucm", GT, 512, 512), board,
                             jax_family("t36h11"), poses, noise=1.5, seed=11)
    ).astype(np.uint8)


def process_state() -> str:
    """The state an earlier test in the same process can leave behind."""
    env = {k: v for k, v in sorted(os.environ.items()) if k.startswith("CCRS_")}
    return f"torch threads {torch.get_num_threads()}, CCRS_* environment {env}"


def assert_same_detections(got, want):
    assert len(got) == len(want), f"{len(got)} frames vs {len(want)}; {process_state()}"
    for f, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (
            f"frame {f}: tags only in the port {sorted(set(g) - set(w))}, only in "
            f"ccrs_tpu {sorted(set(w) - set(g))}; {process_state()}"
        )
        for t in g:
            err = float(np.abs(np.asarray(g[t]) - np.asarray(w[t])).max())
            assert err <= CORNER_TOL, (
                f"frame {f} tag {t}: corners differ by {err:.3e} px; {process_state()}"
            )


def assert_same_stats(stats, jstats):
    diff = {k: (stats.get(k), jstats.get(k)) for k in set(stats) | set(jstats)
            if stats.get(k) != jstats.get(k)}
    assert not diff, f"stats differ (port, ccrs_tpu): {diff}; {process_state()}"


def leave_tpu_traces(imgs, monkeypatch):
    """What tests/test_detector.py's chunk-plan tests leave behind: the
    JAX cold detector traced, at the chunk shapes of the tracked sweeps,
    with ``jax.default_backend`` reporting "tpu"."""
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        det = JaxDetector("t36h11", track=False)
        det.chunk, det.cold_chunk = 4, 2
        det.detect_batch(imgs[:6])


def run_both(imgs, port_imgs=None):
    port_imgs = imgs if port_imgs is None else port_imgs
    jb = jax_board()
    jax.clear_caches()  # no trace made under another backend setting
    jdet = JaxDetector("t36h11", track=True)
    want = jdet.detect_batch(imgs, board=jb)
    det = TagDetector("t36h11", device="cpu")
    assert det.track  # the default
    got = det.detect_batch(port_imgs, board=board_from_ref(jb))
    return got, want, det.stats, jdet.stats


@pytest.mark.parametrize("name", ["video", "bench_like", "shuffled", "video_after_tpu_traces"])
def test_tracked_matches_reference(name, monkeypatch):
    if name == "bench_like":
        imgs = port_imgs = bench_like_frames()
    else:
        imgs, port_imgs = video_frames()
        if name == "shuffled":
            order = [5, 0, 9, 2, 12, 7]
            imgs, port_imgs = imgs[order], port_imgs[order]
        if name == "video_after_tpu_traces":
            leave_tpu_traces(imgs, monkeypatch)
    got, want, stats, jstats = run_both(imgs, port_imgs)
    assert_same_detections(got, want)
    assert_same_stats(stats, jstats)
    if name.startswith("video"):
        # the fixture exercises the audits and a repair resweep
        assert stats["trigger_frames"] > 0 and stats.get("resweeps", 0) > 0
    if name == "bench_like":
        assert stats["waves"] > 0 and stats["cold_frames"] <= len(imgs) // 3
