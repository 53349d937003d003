"""Card-only tests of the PyTorch port: the hand-written CUDA threshold
kernel against its plain torch version, and the cold detector on the card
against the CPU path.  They skip without a CUDA device.

This file imports neither jax nor ``ccrs_tpu``, so it also runs on a
machine with the card and no JAX (``tests/conftest.py`` imports jax, hence
``--noconftest``)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect.threshold import threshold_front, threshold_front_plain
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

torch.set_num_threads(1)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _frames(size, n, noise=0.0, device="cpu"):
    board = create_default_6x6_board()
    s = size / 512.0
    gt = GenericModel("eucm", [p * s for p in GT[:4]] + GT[4:], size, size)
    poses = smooth_sequence_poses(n, board, seed=3)
    gen = torch.Generator(device=device).manual_seed(3) if noise else None
    return render_frames_device(
        gt, board, get_family("t36h11"), poses, noise=noise, generator=gen,
        device=device,
    )


def _random(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,scale",
    [((3, 64, 128), 1), ((3, 479, 751), 1), ((3, 479, 751), 2),
     ((2, 500, 372), 1), ((2, 500, 372), 2), ((1, 7, 9), 1), ((1, 4, 8), 2)],
)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_matches_plain_random(card, shape, scale, dtype):
    """Bit-exact: every value of the threshold pipeline is exact in f32."""
    x = _random(shape, seed=shape[1]).to(dtype).to(card)
    if dtype == torch.float32:
        g = torch.Generator(device=card).manual_seed(1)
        x = x + 0.9 * torch.rand(shape, generator=g, device=card)
    before = threshold_front_cuda.launches
    got = threshold_front(x, scale)
    want = threshold_front_plain(x, scale)
    torch.cuda.synchronize()
    assert threshold_front_cuda.launches == before + 1
    assert got.device.type == "cuda" and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("size,scale", [(512, 1), (1024, 2)])
def test_kernel_matches_plain_boards(card, size, scale):
    x = _frames(size, 8, noise=1.5, device=card)
    got = threshold_front_cuda(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, threshold_front_plain(x, scale))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    x = _random((2, 64, 64)).to(card)
    with pytest.raises(TypeError):
        threshold_front_cuda(x.to(torch.int32))
    with pytest.raises(ValueError):
        threshold_front_cuda(x.mT)  # not contiguous
    with pytest.raises(ValueError):
        threshold_front_cuda(x, scale=3)


@pytest.mark.cuda
def test_detector_on_card_matches_cpu(card):
    frames = _frames(512, 6, noise=1.5)
    board = create_default_6x6_board()
    cpu = TagDetector("t36h11").detect_batch(None, board, dev_images=frames)
    gpu = TagDetector("t36h11", device=card).detect_batch(
        None, board, dev_images=frames.to(card)
    )
    for c, g in zip(cpu, gpu):
        assert sorted(c) == sorted(g)
        for t in c:
            np.testing.assert_allclose(g[t], c[t], rtol=0, atol=1e-3)
