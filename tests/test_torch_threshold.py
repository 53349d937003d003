"""Threshold front-end of the PyTorch port against the JAX package.

Every value of the threshold pipeline is exact in float32, so all
comparisons are bit-exact: the port's plain version against the Pallas
kernel (run in interpret mode, as tests/test_pallas_threshold.py runs it)
and against the JAX ``threshold_front``.  The CUDA kernel against the
plain version is in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.detect.threshold import threshold_front as jax_threshold_front
from ccrs_tpu.ops.threshold_pallas import adaptive_threshold_pallas
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect.families import get_family
from ccrs_tpu_torch.detect.threshold import (
    adaptive_threshold,
    threshold_front,
)
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

torch.set_num_threads(1)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def _board_frames(size, n=1, seed=3):
    """Noise-free rendered board frames (n, size, size) uint8, as numpy."""
    board = create_default_6x6_board()
    s = size / 512.0
    gt = GenericModel("eucm", [p * s for p in GT[:4]] + GT[4:], size, size)
    poses = smooth_sequence_poses(n, board, seed=seed)
    return render_frames_device(gt, board, get_family("t36h11"), poses, noise=0.0).numpy()


def _random(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("case", ["random", "board512"])
def test_plain_matches_pallas_kernel(case):
    """Plain adaptive_threshold(separate=False) == Pallas kernel, bit-exact."""
    imgs = _random((2, 64, 128)) if case == "random" else _board_frames(512)
    want = np.asarray(adaptive_threshold_pallas(jnp.asarray(imgs), interpret=True))
    got = adaptive_threshold(torch.as_tensor(imgs), separate=False).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "case,scale",
    [
        ("random64x128", 1),
        ("board512", 1),
        ("board1024", 2),
        ("random479x751", 1),
        ("random479x751", 2),
        ("random500x372", 1),
        ("random500x372", 2),
    ],
)
def test_threshold_front_matches_jax(case, scale):
    """Plain threshold_front == JAX threshold_front (packed bitmap),
    bit-exact, including widths that are not multiples of 8, 32 or 128
    and odd sizes under the 2x2 pyramid."""
    if case == "board512":
        imgs = _board_frames(512)
    elif case == "board1024":
        imgs = _board_frames(1024)
    else:
        h, w = (int(v) for v in case[len("random"):].split("x"))
        imgs = _random((2, h, w), seed=h)
    want = np.asarray(jax_threshold_front(jnp.asarray(imgs), scale))
    got = threshold_front(torch.as_tensor(imgs), scale)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_float32_input_matches_uint8():
    """The float32 upload path thresholds integer-valued frames exactly as
    the uint8 path does."""
    imgs = torch.as_tensor(_random((2, 96, 120), seed=5))
    for scale in (1, 2):
        np.testing.assert_array_equal(
            threshold_front(imgs.to(torch.float32), scale).numpy(),
            threshold_front(imgs, scale).numpy(),
        )


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never computes a CPU
    tensor itself (the CPU path is the plain version's)."""
    with pytest.raises(ValueError):
        threshold_front_cuda(torch.zeros((1, 8, 8), dtype=torch.uint8))
    assert threshold_front_cuda.launches == 0
