"""The wave-tracking step of the PyTorch port (ccrs_tpu_torch/detect/
track.py) against the JAX package's, on the CPU.

- the unrolled 8x8 Cholesky solve on SPD systems (within 1e-5 relative)
  and on singular ones (NaN on exactly the same batch elements);
- the batched homography fit (within 1e-4 px on the mapped points);
- neighbour selection on the board's tied centre distances: the same
  indices as ``jax.lax.top_k`` (``torch.topk`` picks another set);
- the anchor-triple layout, exactly;
- ``wave_advance`` from one seeded carry: the acc / att / benign masks and
  the next carry's masks and coast ages exact, corners within 1e-3 px; and
  the real rows' results do not depend on how many inactive rows ride
  along (the JAX package pads rows to buckets, the port does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import detector as jax_detector_mod
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu.detect import track as JT
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.testdata import render_board_image, smooth_sequence_poses
from ccrs_tpu_torch import testdata as port_testdata
from ccrs_tpu_torch.detect import detector as port_detector_mod
from ccrs_tpu_torch.detect import get_family
from ccrs_tpu_torch.detect import track as TT
from ccrs_tpu_torch.interop import board_from_ref, model_from_ref, wave_carry_from_ref
from torch_jax_pin import fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px


def _spd(rng, Q):
    A = rng.normal(size=(Q, 12, 8)).astype(np.float32)
    return np.einsum("qij,qik->qjk", A, A) + 0.1 * np.eye(8, dtype=np.float32)


def test_cholesky_solve8_spd():
    rng = np.random.default_rng(0)
    M = _spd(rng, 64)
    rhs = rng.normal(size=(64, 8)).astype(np.float32)
    want = np.asarray(JT._cholesky_solve8(jnp.asarray(M), jnp.asarray(rhs)))
    got = TT._cholesky_solve8(torch.as_tensor(M), torch.as_tensor(rhs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(M, rhs[..., None])[..., 0], rtol=1e-3, atol=1e-4)


def test_cholesky_solve8_singular_poisons_like_jax():
    """Non-positive pivots give NaN rows, on the same batch elements."""
    rng = np.random.default_rng(1)
    M = _spd(rng, 6)
    M[1] = 0.0                      # zero pivot
    M[3, 4, 4] = -5.0               # negative pivot
    v = rng.normal(size=(8, 1)).astype(np.float32)
    M[5] = (v @ v.T)                # rank one: later pivots vanish
    rhs = rng.normal(size=(6, 8)).astype(np.float32)
    want = np.asarray(JT._cholesky_solve8(jnp.asarray(M), jnp.asarray(rhs)))
    got = TT._cholesky_solve8(torch.as_tensor(M), torch.as_tensor(rhs)).numpy()
    np.testing.assert_array_equal(np.isnan(got).all(axis=1), np.isnan(want).all(axis=1))
    assert np.isnan(got[[1, 3]]).all() and np.isfinite(got[[0, 2, 4]]).all()
    ok = np.isfinite(want).all(axis=1)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def test_fit_h_batch():
    rng = np.random.default_rng(2)
    Q = 32
    src = rng.uniform(0, 0.5, size=(Q, 16, 2)).astype(np.float32)
    H = np.tile(np.eye(3), (Q, 1, 1)) + rng.normal(scale=0.05, size=(Q, 3, 3))
    H[:, :2, :2] *= 400.0
    H[:, :2, 2] += 200.0
    p = np.einsum("qij,qnj->qni", H[:, :, :2], src) + H[:, None, :, 2]
    dst = (p[..., :2] / p[..., 2:]).astype(np.float32)
    want = JT._apply_h_batch(JT._fit_h_batch(jnp.asarray(src), jnp.asarray(dst)), jnp.asarray(src))
    Ht = TT._fit_h_batch(torch.as_tensor(src), torch.as_tensor(dst))
    got = TT._apply_h_batch(Ht, torch.as_tensor(src)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, dst, rtol=0, atol=1e-2)


def _board_xy(board):
    return board.p3d.reshape(board.n_tags, 4, 3)[:, :, :2].astype(np.float32)


def test_board_distances_equal_jax():
    """The tag-centre distances carry the board grid's exact ties: they
    must equal the JAX package's values bit for bit."""
    bxy = _board_xy(jax_board())

    @jax.jit
    def jax_d2(b):
        c = b.mean(axis=1)
        return ((c[:, None] - c[None]) ** 2).sum(-1)

    want = np.asarray(jax_d2(jnp.asarray(bxy)))
    got = TT.board_centers_d2(torch.as_tensor(bxy)).numpy()
    np.testing.assert_array_equal(got, want)


def test_neighbor_ties_match_top_k():
    """Six equal distances among 36: torch.topk picks another set than
    jax.lax.top_k; the port's stable sort picks jax's."""
    d = np.full((1, 36), 5.0, np.float32)
    d[0, [3, 9, 20, 30, 31, 33]] = 1.0
    _, want = jax.lax.top_k(-jnp.asarray(d), 4)
    assert list(np.asarray(want)[0]) == [3, 9, 20, 30]
    d2_all = torch.as_tensor(np.tile(d, (36, 1)))
    idx, ok = TT._nearest_valid(d2_all, torch.ones((1, 36), dtype=torch.bool))
    assert idx[0, 0].tolist() == [3, 9, 20, 30] and bool(ok.all())
    # on the real board, with random validity masks: the same neighbours
    bxy = _board_xy(jax_board())
    d2 = TT.board_centers_d2(torch.as_tensor(bxy))
    rng = np.random.default_rng(3)
    valid = rng.random((8, 36)) < 0.6
    idx, ok = TT._nearest_valid(d2, torch.as_tensor(valid))
    for r in range(8):
        d2m = jnp.asarray(d2.numpy()) + jnp.where(jnp.asarray(valid[r]), 0.0, 1e12)[None, :]
        negd, want = jax.lax.top_k(-d2m, JT.N_NEIGHBORS)
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(want))
        np.testing.assert_array_equal(ok[r].numpy(), np.asarray((-negd < 1e11).all(axis=1)))


@pytest.mark.parametrize("B", [3, 4, 5, 6, 7, 14, 43, 44, 45, 48, 86, 534])
@pytest.mark.parametrize("K,p0", [(40, 0), (8, 0), (8, 5), (4, 2)])
def test_anchor_starts(B, K, p0):
    assert port_detector_mod._anchor_starts(B, K, p0) == jax_detector_mod._anchor_starts(B, K, p0)


@pytest.fixture(scope="module")
def wave_case():
    """Three frames of a slow sequence; the carry seeds from the cold
    detections of frames 0 and 1, and the wave runs on frame 2."""
    board = jax_board()
    fam = jax_family("t36h11")
    model = JaxModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(3, board, seed=5, keyframe_every=16)
    imgs = np.stack([
        render_board_image(model, board, fam, p[:3], p[3:], noise=1.0, seed=f)
        for f, p in enumerate(poses)
    ])
    cold = JaxDetector("t36h11", track=False).detect_batch(imgs[:2], board=board)
    c1, v1 = JT.detections_to_arrays(cold[1], board)
    c2, v2 = JT.detections_to_arrays(cold[0], board)
    # row 0 tracks; row 1 has tags 0-11 of its seed dropped (so prediction
    # falls back to coasting and the neighbour homography); row 2 inactive
    v1b = v1.copy()
    v1b[:12] = False
    carry = JT.init_wave_carry(
        np.stack([c1, c1, c1]), np.stack([v1, v1b, v1]),
        np.stack([c2, c2, c2]), np.stack([v2, v2, v2]),
    )
    active = np.array([True, True, False])
    wave_imgs = np.stack([imgs[2]] * 3)
    # the port's wave runs on the frame its own renderer makes (equal pixel
    # for pixel, tests/test_torch_testdata.py)
    port_img = port_testdata.render_board_image(
        model_from_ref(model), board_from_ref(board), get_family("t36h11"),
        poses[2, :3], poses[2, 3:], noise=1.0, seed=2,
    )
    jc, jo = JT.wave_advance(
        fam, jnp.asarray(wave_imgs), jnp.asarray(_board_xy(board)),
        jnp.asarray(np.int32(board.config.first_id)),
        tuple(jnp.asarray(a) for a in carry), jnp.asarray(active),
    )
    return dict(board=board, carry=carry, active=active, imgs=np.stack([port_img] * 3),
                jax_carry=[np.asarray(a) for a in jc], jax_out=[np.asarray(a) for a in jo],
                n_cold=len(cold[1]))


def _port_wave(case, rows=None, pad=0):
    rows = list(range(3)) if rows is None else rows
    board = case["board"]
    carry = [a[rows] for a in case["carry"]]
    imgs, active = case["imgs"][rows], case["active"][rows]
    if pad:
        carry = [np.concatenate([a, np.repeat(a[-1:], pad, 0)]) for a in carry]
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
        active = np.concatenate([active, np.zeros(pad, bool)])
    return TT.wave_advance(
        get_family("t36h11"), torch.as_tensor(imgs), torch.as_tensor(_board_xy(board)),
        board.config.first_id, wave_carry_from_ref(carry), torch.as_tensor(active),
    )


def test_wave_advance_matches_jax(wave_case):
    c = wave_case
    carry, out = _port_wave(c)
    cor, acc, att, ben = (t.numpy() for t in out)
    jcor, jacc, jatt, jben = c["jax_out"]
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(att, jatt)
    np.testing.assert_array_equal(ben, jben)
    assert acc[0].sum() >= c["n_cold"] - 2 and acc[1, 12:].sum() >= acc[0, 12:].sum() - 2
    assert att[2].sum() == 0 and acc[2].sum() == 0 and (acc <= att).all()
    np.testing.assert_allclose(cor[acc], jcor[acc], rtol=0, atol=CORNER_TOL)
    for k, (got, want) in enumerate(zip(carry, c["jax_carry"])):
        got = got.numpy()
        assert got.dtype == want.dtype, k
        if got.dtype == np.float32:
            np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=CORNER_TOL, err_msg=str(k))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(k))


def test_wave_rows_do_not_interact(wave_case):
    """The real rows' outputs are the same alone, in the full batch and
    with inactive padding rows, which decode nothing."""
    _, full = _port_wave(wave_case)
    for rows, pad in (([0], 0), ([1], 0), ([0, 1], 5)):
        _, out = _port_wave(wave_case, rows, pad)
        for got, want in zip(out, full):
            np.testing.assert_array_equal(got[: len(rows)].numpy(), want[rows].numpy())
        if pad:
            assert not out[1][len(rows):].any() and not out[2][len(rows):].any()
