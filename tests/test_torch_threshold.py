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
    threshold_front_plain,
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
    return render_frames_device(gt, board, get_family("t36h11"), poses, noise=0.0, device="cpu").numpy()


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


def _lane_min(a, b):
    """Minimum of each 16-bit lane of two words (int64 tensors)."""
    return torch.minimum(a & 0xFFFF, b & 0xFFFF) | (torch.minimum(a >> 16, b >> 16) << 16)


def _spread2(x):
    """The eight 2-bit units of a 16-bit x moved to bits 4k, 4k+1."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    return (x | (x << 2)) & 0x33333333


def _kernel_rules(imgs, scale, min_contrast):
    """The CUDA kernel's integer formulation for uint8 input, in plain torch:
    values v (pixels, or 2x2 sums in [0, 1020] at scale 2 with white
    padding 1020); a tile's statistics as one word, min in the low 16-bit
    lane and 0xFFFF - max in the high one (0xFFFFFFFF outside the frame),
    dilated by a lane-wise minimum over 3x3 tiles; the contrast test
    (float)(max - min) >= min_contrast (4 * min_contrast at scale 2); the
    white test as bit 15 of v + 0x8000 - q with q = ((min + max) >> 1) + 1,
    or q = 0 at low contrast, on lanes (pixel 0, pixel 1) and (pixel 2,
    pixel 3) of each 4-pixel group; the two lane words' bits gathered and
    interleaved into 32-pixel masks (bit i = column i), ORed with their
    neighbours shifted by one bit and row, bit-reversed and byte-swapped
    into most-significant-bit-first bytes."""
    x = torch.as_tensor(imgs).to(torch.int64)
    B, H, W = x.shape
    need = np.float32(min_contrast)
    if scale == 2:
        x = x[:, : H // 2 * 2, : W // 2 * 2]
        x = x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]
        white, need = 1020, np.float32(4) * need
    else:
        white = 255
    sH, sW = x.shape[1:]
    sHp, sWp = sH + (-sH) % 4, sW + (-sW) % 8
    x = torch.nn.functional.pad(x, (0, sWp - sW, 0, sHp - sH), value=white)
    t = x.reshape(B, sHp // 4, 4, sWp // 4, 4)
    stat = t.amin(dim=(2, 4)) | ((0xFFFF - t.amax(dim=(2, 4))) << 16)
    stat = torch.nn.functional.pad(stat, (1, 1, 1, 1), value=0xFFFFFFFF)
    th, tw = sHp // 4, sWp // 4
    m = torch.full((B, th, tw), 0xFFFFFFFF, dtype=torch.int64)
    for a in range(3):
        for c in range(3):
            m = _lane_min(m, stat[:, a:a + th, c:c + tw])
    nmin, nmax = m & 0xFFFF, 0xFFFF - (m >> 16)
    ok = (nmax - nmin).to(torch.float32) >= torch.tensor(need)
    q = torch.where(ok, ((nmin + nmax) >> 1) + 1, torch.zeros_like(nmin))
    K = (0x8000 - q) * 0x00010001  # per tile, one per 4-pixel group of a row
    K = K.repeat_interleave(4, 1)  # (B, sHp, tw)
    # 32-pixel words: tw padded to a multiple of 8 groups; columns past sWp are 0
    nw = -(-sWp // 32)
    g = x.reshape(B, sHp, tw, 4)
    g = torch.nn.functional.pad(g, (0, 0, 0, 8 * nw - tw))
    K = torch.nn.functional.pad(K, (0, 8 * nw - tw))
    lo = (g[..., 0] | (g[..., 1] << 16)) + K
    hi = (g[..., 2] | (g[..., 3] << 16)) + K
    shift = 15 - 2 * torch.arange(8)
    A = (((lo & 0x80008000).reshape(B, sHp, nw, 8)) >> shift).sum(-1)
    Bw = (((hi & 0x80008000).reshape(B, sHp, nw, 8)) >> shift).sum(-1)
    a = (A & 0x5555) | ((A >> 15) & 0xAAAA)
    c = (Bw & 0x5555) | ((Bw >> 15) & 0xAAAA)
    words = _spread2(a) | (_spread2(c) << 2)
    col = 32 * torch.arange(nw)[:, None] + torch.arange(32)
    inside = ((col < sWp).to(torch.int64) << torch.arange(32)).sum(-1)
    words = torch.nn.functional.pad(words & inside, (1, 1, 1, 1))  # 0 outside the frame
    mid = words[:, :, 1:-1]
    h = mid | ((mid << 1) & 0xFFFFFFFF) | (words[:, :, :-2] >> 31) | (mid >> 1) | (
        (words[:, :, 2:] << 31) & 0xFFFFFFFF)
    v = h[:, :-2] | h[:, 1:-1] | h[:, 2:]
    rev = (((v[..., None] >> torch.arange(32)) & 1) << (31 - torch.arange(32))).sum(-1)
    swapped = sum(((rev >> (8 * j)) & 0xFF) << (8 * (3 - j)) for j in range(4))
    out = torch.stack([(swapped >> (8 * j)) & 0xFF for j in range(4)], -1)
    return out.reshape(B, sHp, 4 * nw)[:, :, : sWp // 8].to(torch.uint8)


@pytest.mark.parametrize("min_contrast", [0.0, 20.0, 20.5, 255.0])
@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("hw", [(64, 128), (479, 751), (500, 372), (7, 9), (33, 70), (4, 8)])
def test_integer_formulation_matches_plain(hw, scale, min_contrast):
    """The kernel's exactness argument on the CPU: its integer rules give
    threshold_front_plain's bitmap bit for bit, on a full-range random
    frame and a low-contrast one (gray levels 100..125, where the contrast
    test decides)."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    imgs = np.stack([rng.integers(0, 256, hw, np.uint8), rng.integers(100, 126, hw, np.uint8)])
    want = threshold_front_plain(torch.as_tensor(imgs), scale, min_contrast=min_contrast)
    got = _kernel_rules(imgs, scale, min_contrast)
    assert got.shape == want.shape
    assert torch.equal(got, want)
