"""Detection under imaging stressors through both packages on the CPU.

The scenes of three JAX-package tests, rendered by the port's host
renderer (pixel-equal to the JAX one) and fed to both detectors:

- ``tests/test_stressors.py``: 6 frames under motion blur of 3, 5 and 7
  px, heavy vignette, a 2 px board warp, and all combined;
- ``tests/test_track_shake.py``: the 16-frame high-acceleration shake
  video, tracked and cold;
- ``tests/test_robustness.py``: 16 frames under vignetting, an
  illumination gradient, gamma, low contrast and heavy noise, tracked.

Tag ids are equal frame by frame and corners agree within 1e-3 px
(measured: 2.4e-4).  The harsh frames are then calibrated from one
``FrameBatch`` (the JAX package's, carried over by ``interop``) with the
random draws injected: medians within 1e-6 px (measured 2.5e-8).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.calib import init_and_calibrate_one_camera as jax_calibrate
from ccrs_tpu.calib import validation as jax_validation
from ccrs_tpu.calib.frames import FrameBatch as JaxFrameBatch
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.models import zeros_like_model as jax_zeros
from ccrs_tpu.types import CalibParams as JaxCalibParams
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib import init_and_calibrate_one_camera, validation
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.interop import frame_batch_from_ref
from ccrs_tpu_torch.models import GenericModel, zeros_like_model
from ccrs_tpu_torch.testdata import (
    default_sequence_poses,
    render_board_image,
    smooth_sequence_poses,
)
from ccrs_tpu_torch.types import CalibParams
from test_torch_calib_all_models import port_takes_jax_draws
from torch_jax_pin import assert_same_detections, fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

CORNER_TOL = 1e-3  # px
MEDIAN_TOL = 1e-6  # px
GT = ("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)


def detect_both(imgs, track):
    want = JaxDetector("t36h11", track=track).detect_batch(imgs, board=jax_board())
    got = TagDetector("t36h11", track=track, device="cpu").detect_batch(
        imgs, board=create_default_6x6_board())
    worst = assert_same_detections(got, want, CORNER_TOL)
    return got, want, worst


def render(poses, **kw):
    board, fam, model = create_default_6x6_board(), get_family("t36h11"), GenericModel(*GT)
    return np.stack([
        render_board_image(model, board, fam, p[:3], p[3:], seed=f, **kw)
        for f, p in enumerate(poses)
    ])


@pytest.fixture(scope="module")
def scene():
    poses = smooth_sequence_poses(6, create_default_6x6_board(), seed=21, keyframe_every=8)
    return render(poses, noise=1.0)


def motion_blur(imgs, length=7, angle_deg=30.0):
    """Directional box blur (camera shake during exposure)."""
    from scipy.ndimage import convolve

    k = np.zeros((length, length), np.float64)
    a = np.deg2rad(angle_deg)
    c = (length - 1) / 2
    for i in range(length * 4):
        t = -c + i * (2 * c) / (length * 4 - 1)
        k[int(round(c + t * np.sin(a))), int(round(c + t * np.cos(a)))] = 1.0
    k /= k.sum()
    out = np.stack([convolve(im.astype(np.float64), k, mode="nearest") for im in imgs])
    return np.clip(out, 0, 255).astype(np.uint8)


def vignette(imgs, strength=0.65):
    yy, xx = np.mgrid[0 : imgs.shape[1], 0 : imgs.shape[2]]
    cy, cx = (imgs.shape[1] - 1) / 2, (imgs.shape[2] - 1) / 2
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / (cx**2 + cy**2)
    return np.clip(imgs.astype(np.float64) * (1.0 - strength * r2), 0, 255).astype(np.uint8)


def board_warp(imgs, amp=2.0, wavelength=170.0):
    """Mild out-of-plane board bow as a sinusoidal displacement field."""
    from scipy.ndimage import map_coordinates

    _, H, W = imgs.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx = amp * np.sin(2 * np.pi * yy / wavelength)
    dy = amp * np.cos(2 * np.pi * xx / wavelength)
    out = np.stack([
        map_coordinates(im.astype(np.float64), [yy + dy, xx + dx], order=1, mode="nearest")
        for im in imgs
    ])
    return np.clip(out, 0, 255).astype(np.uint8)


STRESSORS = {
    "clean": lambda x: x,
    "blur3": lambda x: motion_blur(x, length=3),
    "blur5": lambda x: motion_blur(x, length=5),
    "blur7": lambda x: motion_blur(x, length=7),
    "vignette": vignette,
    "warp": board_warp,
    "combined": lambda x: vignette(motion_blur(board_warp(x), length=3), 0.5),
}
#: fewest (frame, tag) pairs the six frames must still show (the recall
#: floors of tests/test_stressors.py, as counts; 7 px blur resolves nothing)
MIN_TAGS = {"clean": 120, "blur3": 100, "blur5": 50, "blur7": 0, "vignette": 110,
            "warp": 110, "combined": 80}


@pytest.mark.parametrize("name", list(STRESSORS))
def test_stressor_detections_match(scene, name):
    got, _, _ = detect_both(STRESSORS[name](scene), track=False)
    assert sum(len(d) for d in got) >= MIN_TAGS[name]


@pytest.fixture(scope="module")
def shake_video():
    """16 frames of smooth motion plus a zig-zag rotational shake whose
    sign alternates every frame (tests/test_track_shake.py)."""
    n = 16
    poses = smooth_sequence_poses(n, create_default_6x6_board(), seed=7, keyframe_every=8)
    rng = np.random.default_rng(11)
    shake = np.zeros_like(poses)
    for f in range(n):
        shake[f, :2] = 0.012 * (1 if f % 2 == 0 else -1) * (1 + 0.5 * rng.random(2))
    return render(poses + shake, noise=1.5)


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "cold"])
def test_shake_video_matches(shake_video, track):
    got, _, _ = detect_both(shake_video, track)
    assert sum(len(d) for d in got) >= len(shake_video) * 20  # hard, not degenerate


@pytest.fixture(scope="module")
def harsh():
    """The frames of tests/test_robustness.py and both packages' tracked
    detections of them."""
    poses = default_sequence_poses(16, create_default_6x6_board(), seed=31)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:512]
    vign = 1.0 - 0.55 * (((xx - 256) ** 2 + (yy - 256) ** 2) / (2 * 256**2))
    grad = 0.75 + 0.5 * xx / 511.0
    imgs = []
    for im in render(poses, noise=0.0, blur_sigma=1.0).astype(np.float32):
        im = (im * vign * grad) ** 0.9
        im = im * 0.55 + 20
        im += rng.normal(size=im.shape) * 4.0
        imgs.append(np.clip(im, 0, 255).astype(np.uint8))
    return detect_both(np.stack(imgs), track=True)


def test_harsh_frames_match(harsh):
    got, _, worst = harsh
    assert sum(len(d) >= 6 for d in got) >= 12 and worst <= CORNER_TOL


def test_harsh_frames_calibrate_alike(harsh, monkeypatch):
    """One FrameBatch (the JAX detections) through both calibrations."""
    _, want, _ = harsh
    jb = jax_board()
    batch = JaxFrameBatch.from_detections(want, list(range(16)), jb, 512, 512)
    assert batch.frame_ok().sum() >= 12
    jres = jax_calibrate(jb, batch, jax_zeros("eucm"), JaxCalibParams(),
                         jax.random.PRNGKey(0), rng=np.random.default_rng(0))
    tb, tbatch = create_default_6x6_board(), frame_batch_from_ref(batch)
    with port_takes_jax_draws(monkeypatch, 0):
        tres = init_and_calibrate_one_camera(
            tb, tbatch, zeros_like_model("eucm"), CalibParams(),
            torch.Generator().manual_seed(0), rng=np.random.default_rng(0), device="cpu")
    assert jres is not None and tres is not None
    with contextlib.redirect_stdout(io.StringIO()):
        _, med_j = jax_validation(jb, batch, *jres)
        _, med_t = validation(tb, tbatch, *tres)
    assert abs(tres[0].params[0] - GT[1][0]) / GT[1][0] < 0.01 and med_t < 0.5
    assert abs(med_t - med_j) < MEDIAN_TOL, (med_t, med_j)
