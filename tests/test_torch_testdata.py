"""Renderer and pose generator of the PyTorch port against the JAX package.

Poses are made with numpy on the host in both packages and must agree
within 1e-12.  The noise-free float32 render must agree within 1 gray level
on all but 1e-4 of the pixels: the two frameworks round the float32 pose
rotation differently by a few ulps, which moves texel edges by ~1e-7 of a
cell and flips the rare supersample that lands exactly on an edge; one of
the 9 supersamples flipping between black (35) and white (220) moves a
pixel by at most 185/9 < 21 gray levels.

``render_board_image`` renders one frame on the host in float64 in both
packages, with scipy's Gaussian filter and numpy's seeded noise: its pixels
are equal (tolerance 0), with and without noise, for two seeds and for
square and non-square sensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu import testdata as JT
from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu_torch import testdata as TT
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import get_family
from ccrs_tpu_torch.models import GenericModel

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


@pytest.mark.parametrize("n_frames,seed", [(40, 11), (534, 11), (17, 3)])
def test_smooth_sequence_poses_match(n_frames, seed):
    want = JT.smooth_sequence_poses(n_frames, jax_board(), seed=seed)
    got = TT.smooth_sequence_poses(n_frames, create_default_6x6_board(), seed=seed)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_board_pattern_matches():
    tex_j, org_j, sc_j = JT.board_pattern_image(jax_board(), jax_family("t36h11"))
    tex_t, org_t, sc_t = TT.board_pattern_image(
        create_default_6x6_board(), get_family("t36h11")
    )
    np.testing.assert_array_equal(tex_t, tex_j)
    assert org_t == org_j and sc_t == sc_j


@pytest.mark.parametrize("size", [512, 384])
def test_noise_free_render_matches(size):
    s = size / 512.0
    params = [p * s for p in GT[:4]] + GT[4:]
    poses = JT.smooth_sequence_poses(24, jax_board(), seed=11)[::8]
    want = np.asarray(JT.render_frames_device(
        JaxModel("eucm", params, size, size), jax_board(), jax_family("t36h11"),
        poses, noise=0.0, seed=0,
    )).astype(np.int32)
    got = TT.render_frames_device(
        GenericModel("eucm", params, size, size), create_default_6x6_board(),
        get_family("t36h11"), poses, noise=0.0,
        device="cpu",
    )
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert (diff > 1).mean() <= 1e-4, (diff > 1).sum()
    assert diff.max() < 21


def test_noise_needs_a_generator():
    with pytest.raises(ValueError):
        TT.render_frames_device(
            GenericModel("eucm", GT, 64, 64), create_default_6x6_board(),
            get_family("t36h11"), np.zeros((1, 6)), noise=1.0,
            device="cpu",
        )


def test_seeded_noise_is_reproducible():
    board = create_default_6x6_board()
    poses = TT.smooth_sequence_poses(2, board, seed=1)
    model = GenericModel("eucm", [p / 4 for p in GT[:4]] + GT[4:], 128, 128)

    def render(seed):
        return TT.render_frames_device(
            model, board, get_family("t36h11"), poses, noise=1.5,
            generator=torch.Generator().manual_seed(seed),
            device="cpu",
        )

    assert torch.equal(render(3), render(3))
    assert not torch.equal(render(3), render(4))


BOARD_IMAGE_MODELS = {
    "eucm512": ("eucm", GT, 512, 512),
    "opencv5_643x481": (
        "opencv5", [400.0, 398.0, 321.0, 240.0, -0.28, 0.09, 0.001, -0.0005, -0.01], 643, 481,
    ),
}


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (1.5, 1), (1.5, 7)])
@pytest.mark.parametrize("spec", list(BOARD_IMAGE_MODELS))
def test_render_board_image_matches(spec, noise, seed):
    """Float64 on both sides: every pixel equal."""
    name, params, w, h = BOARD_IMAGE_MODELS[spec]
    pose = JT.default_sequence_poses(2, jax_board(), seed=3)[1]
    want = JT.render_board_image(
        JaxModel(name, params, w, h), jax_board(), jax_family("t36h11"),
        pose[:3], pose[3:], noise=noise, seed=seed,
    )
    got = TT.render_board_image(
        GenericModel(name, params, w, h), create_default_6x6_board(), get_family("t36h11"),
        pose[:3], pose[3:], noise=noise, seed=seed,
    )
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == (h, w)
    assert got.min() < 60 and got.max() > 200  # the board is in view
    np.testing.assert_array_equal(got, want)


def test_render_board_image_options_match():
    """``ss``, ``blur_sigma`` and ``corner_squares`` follow the reference."""
    pose = JT.default_sequence_poses(1, jax_board(), seed=5)[0]
    kw = dict(ss=2, blur_sigma=0.0, corner_squares=False, noise=0.5, seed=4)
    want = JT.render_board_image(
        JaxModel("eucm", GT, 256, 256), jax_board(), jax_family("t36h11"), pose[:3], pose[3:], **kw
    )
    got = TT.render_board_image(
        GenericModel("eucm", GT, 256, 256), create_default_6x6_board(), get_family("t36h11"),
        pose[:3], pose[3:], **kw
    )
    np.testing.assert_array_equal(got, want)
