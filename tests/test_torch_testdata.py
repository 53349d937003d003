"""Renderer and pose generator of the PyTorch port against the JAX package.

Poses are made with numpy on the host in both packages and must agree
within 1e-12.  The noise-free float32 render must agree within 1 gray level
on all but 1e-4 of the pixels: the two frameworks round the float32 pose
rotation differently by a few ulps, which moves texel edges by ~1e-7 of a
cell and flips the rare supersample that lands exactly on an edge; one of
the 9 supersamples flipping between black (35) and white (220) moves a
pixel by at most 185/9 < 21 gray levels."""

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
        )


def test_seeded_noise_is_reproducible():
    board = create_default_6x6_board()
    poses = TT.smooth_sequence_poses(2, board, seed=1)
    model = GenericModel("eucm", [p / 4 for p in GT[:4]] + GT[4:], 128, 128)

    def render(seed):
        return TT.render_frames_device(
            model, board, get_family("t36h11"), poses, noise=1.5,
            generator=torch.Generator().manual_seed(seed),
        )

    assert torch.equal(render(3), render(3))
    assert not torch.equal(render(3), render(4))
