"""The cold detect -> calibrate slice of the PyTorch port against the JAX
package, end to end on the CPU.

16 frames of a smooth 512x512 sequence rendered by the JAX renderer go into
both packages.  Detection must give the same tag ids per frame.  The
calibrations then run on the same observations (the JAX package's
FrameBatch, carried over with ``interop``) and must land on the same EUCM
optimum: RMS within 1e-6 px (the interchange target in BASELINE.md),
parameters within 1e-5 relative, median and best-99% within 1e-6 px.  The
RANSAC draws differ between the packages (threefry keys against a torch
Generator); the BA optimum does not depend on which valid hypothesis
seeded it."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.calib import validation as jax_validation
from ccrs_tpu.calib.frames import FrameBatch as JaxFrameBatch
from ccrs_tpu.calib.pipeline import calibrate_camera_with_retries as jax_calibrate
from ccrs_tpu.calib.validate import reprojection_errors as jax_reproj
from ccrs_tpu.detect import TagDetector as JaxDetector, get_family as jax_family
from ccrs_tpu.models import GenericModel as JaxModel, zeros_like_model as jax_zeros
from ccrs_tpu.testdata import render_frames_device as jax_render
from ccrs_tpu.testdata import smooth_sequence_poses as jax_poses
from ccrs_tpu.types import CalibParams as JaxCalibParams
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib import validation
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
from ccrs_tpu_torch.calib.validate import reprojection_errors
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.interop import frame_batch_from_ref
from ccrs_tpu_torch.models import zeros_like_model
from ccrs_tpu_torch.types import CalibParams

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
N_FRAMES = 16
SIZE = 512


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _rms(per_frame):
    errs = np.concatenate([e for _, e, _ in per_frame])
    return float(np.sqrt(np.mean(errs**2)))


@pytest.fixture(scope="module")
def slice_runs():
    jb = jax_board()
    gt = JaxModel("eucm", GT, SIZE, SIZE)
    poses = jax_poses(N_FRAMES * 4, jb, seed=11)[::4]
    imgs = np.asarray(
        jax_render(gt, jb, jax_family("t36h11"), poses, noise=1.5, seed=11)
    )
    times = list(range(N_FRAMES))
    jdets = JaxDetector("t36h11", track=False).detect_batch(imgs, board=jb)
    tb = create_default_6x6_board()
    tdets = TagDetector("t36h11", track=False).detect_batch(imgs, board=tb)
    jbatch = JaxFrameBatch.from_detections(jdets, times, jb, SIZE, SIZE)
    tbatch = FrameBatch.from_detections(tdets, times, tb, SIZE, SIZE)
    jmodel, jrt = jax_calibrate(
        jb, jbatch, jax_zeros("eucm"), JaxCalibParams(), jax.random.PRNGKey(0)
    )
    # the port on the reference's observations, and on its own
    shared = frame_batch_from_ref(jbatch)
    tmodel, trt = calibrate_camera_with_retries(
        tb, shared, zeros_like_model("eucm"), CalibParams(),
        torch.Generator().manual_seed(0),
    )
    own_model, own_rt = calibrate_camera_with_retries(
        tb, tbatch, zeros_like_model("eucm"), CalibParams(),
        torch.Generator().manual_seed(0),
    )
    return dict(
        gt=gt, jdets=jdets, tdets=tdets, jb=jb, tb=tb, jbatch=jbatch,
        shared=shared, tbatch=tbatch, jmodel=jmodel, jrt=jrt, tmodel=tmodel,
        trt=trt, own_model=own_model, own_rt=own_rt,
    )


def test_detections_match(slice_runs):
    r = slice_runs
    for f, (t, j) in enumerate(zip(r["tdets"], r["jdets"])):
        assert sorted(t) == sorted(j), f"frame {f}"
        for tag in t:
            np.testing.assert_allclose(t[tag], j[tag], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(r["tbatch"].mask, r["jbatch"].mask)


def test_calibration_matches_reference(slice_runs):
    r = slice_runs
    np.testing.assert_allclose(r["tmodel"].params, r["jmodel"].params, rtol=1e-5)
    rms_t = _rms(reprojection_errors(r["tb"], r["shared"], r["tmodel"], r["trt"]))
    rms_j = _rms(jax_reproj(r["jb"], r["jbatch"], r["jmodel"], r["jrt"]))
    assert abs(rms_t - rms_j) < 1e-6, (rms_t, rms_j)
    avg99_t, med_t = _quiet(validation, r["tb"], r["shared"], r["tmodel"], r["trt"])
    avg99_j, med_j = _quiet(jax_validation, r["jb"], r["jbatch"], r["jmodel"], r["jrt"])
    assert abs(med_t - med_j) < 1e-6 and abs(avg99_t - avg99_j) < 1e-6


def test_port_slice_meets_bench_gates(slice_runs):
    """The port's own composition (its detections, its calibration) passes
    the benchmark's gates: focal within 1%, median below 0.3 px."""
    r = slice_runs
    model = r["own_model"]
    focal_err = abs(model.params[0] - GT[0]) / GT[0]
    _, median = _quiet(validation, r["tb"], r["tbatch"], model, r["own_rt"])
    assert focal_err < 0.01 and median < 0.3, (focal_err, median)


def _synthetic(n_frames, seed):
    from synthetic import make_synthetic_batch, tumvi_like_eucm

    batch, _ = make_synthetic_batch(tumvi_like_eucm(), jax_board(), n_frames=n_frames, seed=seed)
    return frame_batch_from_ref(batch)


def test_fixed_focal_calibration():
    """CalibParams(fixed_focal=...) pins fx = fy through the fixed-focal
    re-solve (the gates of tests/test_calib_e2e.py)."""
    from ccrs_tpu_torch.calib import init_and_calibrate_one_camera

    tb = create_default_6x6_board()
    batch = _synthetic(12, seed=3)
    model, rtvecs = init_and_calibrate_one_camera(
        tb, batch, zeros_like_model("eucm"), CalibParams(fixed_focal=190.9),
        torch.Generator().manual_seed(2),
    )
    assert model.params[0] == 190.9 and model.params[1] == 190.9
    _, median = _quiet(validation, tb, batch, model, rtvecs)
    assert median < 0.05  # fy_gt != fx_gt, so not exactly 0


def test_disabled_distortion_pins_beta():
    from ccrs_tpu_torch.calib import calib_camera
    from ccrs_tpu_torch.models import GenericModel

    batch = _synthetic(12, seed=4)
    model0 = GenericModel("eucm", [200, 200, 256, 256, 0.5, 1.0], 512, 512)
    model, _ = calib_camera(
        create_default_6x6_board(), batch, model0, xy_same_focal=False,
        disabled_distortions=1, fixed_focal=False,
    )
    assert model.params[5] == 0.0
