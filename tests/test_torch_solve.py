"""Solvers of the PyTorch port against the JAX package, float64 on the CPU:
SE(3) within 1e-12, planar PnP within 1e-9, RANSAC homography (fed JAX's
own draws) within 1e-9, the focal closed form, and the Schur BA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.models.projections import project_fn as jax_project_fn
from ccrs_tpu.solve import homography as JH, lm as JL, pnp as JPNP, se3 as JS
from ccrs_tpu_torch.interop import board_from_ref, frame_batch_from_ref, rvectvec_from_ref
from ccrs_tpu_torch.models.projections import project_fn
from ccrs_tpu_torch.solve import homography as TH, lm as TL, pnp as TPNP, se3 as TS

from synthetic import make_synthetic_batch, tumvi_like_eucm

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rvecs():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(64, 3))
    r[:4] = [[0, 0, 0], [1e-6, 0, 0], [0, 0, np.pi], [np.pi - 1e-8, 0, 0]]
    return r


def test_se3_matches():
    r = _rvecs()
    t = np.random.default_rng(1).normal(size=(64, 3))
    np.testing.assert_allclose(
        TS.exp_so3(_t(r)).numpy(), np.asarray(JS.exp_so3(jnp.asarray(r))), atol=1e-12
    )
    R = np.asarray(JS.exp_so3(jnp.asarray(r)))
    np.testing.assert_allclose(
        TS.log_so3(_t(R)).numpy(), np.asarray(JS.log_so3(jnp.asarray(R))), atol=1e-12
    )
    got = TS.compose(_t(r), _t(t), _t(r[::-1].copy()), _t(t[::-1].copy()))
    want = JS.compose(*(jnp.asarray(a) for a in (r, t, r[::-1], t[::-1])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)


def _views(n_frames=6, seed=1):
    board = jax_board()
    batch, poses = make_synthetic_batch(
        tumvi_like_eucm(), board, n_frames=n_frames, seed=seed, px_noise=0.3
    )
    return board, batch, poses


def test_solve_pnp_planar_matches():
    board, batch, poses = _views()
    rng = np.random.default_rng(2)
    p3d = board.p3d.astype(np.float64)
    R = np.asarray(jax.vmap(JS.exp_so3)(jnp.asarray(poses[:, :3])))
    pc = np.einsum("nj,fij->fni", p3d, R) + poses[:, None, 3:]
    obs = pc[..., :2] / pc[..., 2:3] + rng.normal(size=pc[..., :2].shape) * 1e-3
    w = batch.mask.astype(np.float64)
    p3d_b = np.broadcast_to(p3d, (len(poses),) + p3d.shape).copy()
    jr, jt = jax.vmap(JPNP.solve_pnp_planar)(
        jnp.asarray(p3d_b), jnp.asarray(obs), jnp.asarray(w)
    )
    tr, tt = TPNP.solve_pnp_planar(_t(p3d_b), _t(obs), _t(w))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-9)


def test_solve_pnp_planar_batch_matches():
    """The batch case of tests/test_pnp.py (six random noise-free poses):
    rvec and tvec within 1e-7 of the truth and within 1e-9 of the JAX
    package's ``solve_pnp_planar_batch``."""
    from ccrs_tpu_torch.solve import solve_pnp_planar_batch

    rng = np.random.default_rng(5)
    p3d = np.zeros((6, 40, 3))
    p3d[..., :2] = rng.uniform(0, 0.5, (6, 40, 2))
    rvec = rng.normal(size=(6, 3)) * 0.3
    tvec = np.array([0.1, -0.2, 0.8]) + rng.normal(size=(6, 3)) * 0.05
    R = np.asarray(jax.vmap(JS.exp_so3)(jnp.asarray(rvec)))
    pc = np.einsum("fnj,fij->fni", p3d, R) + tvec[:, None]
    obs = pc[..., :2] / pc[..., 2:3]
    w = np.ones(p3d.shape[:2])
    jr, jt = JPNP.solve_pnp_planar_batch(jnp.asarray(p3d), jnp.asarray(obs), jnp.asarray(w))
    r, t = solve_pnp_planar_batch(_t(p3d), _t(obs), _t(w))
    assert r.shape == t.shape == (6, 3) and r.dtype == F64
    np.testing.assert_allclose(r.numpy(), rvec, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t.numpy(), tvec, rtol=0, atol=1e-7)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-9)


def _jax_draws(key, mask, n_samples):
    """The (n_samples, 6) subsets JAX's RANSAC draws from ``key``."""
    keys = jax.random.split(key, n_samples)

    def one(k):
        g = jax.random.gumbel(k, (mask.shape[0],), dtype=jnp.float64)
        return jax.lax.top_k(jnp.where(mask, g, -jnp.inf), 6)[1]

    return np.asarray(jax.vmap(one)(keys))


def test_radial_distortion_homography_with_jax_draws():
    board, batch, _ = _views(4, seed=3)
    half = 256.0
    q0 = (batch.p2d[0] - 256.0) / half
    q1 = (batch.p2d[1] - 256.0) / half
    mask = batch.mask[0] & batch.mask[1]
    key = jax.random.PRNGKey(7)
    n = 200
    jl, jh, js = JH.radial_distortion_homography(
        key, jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(mask), n_samples=n
    )
    idx = torch.as_tensor(_jax_draws(key, jnp.asarray(mask), n))
    tl, th, ts = TH.radial_distortion_homography(
        _t(q0), _t(q1), torch.as_tensor(mask), n_samples=n, idx=idx
    )
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-9, atol=1e-12)
    f_t, ok_t = TH.homography_to_focal_traced(th)
    f_j, ok_j = JH.homography_to_focal_traced(jh)
    assert bool(ok_t) == bool(ok_j)
    np.testing.assert_allclose(float(f_t), float(f_j), rtol=1e-9)
    (f_t, ok_t), (f_j, ok_j) = (
        TH.homography_to_focal(th.numpy()), JH.homography_to_focal(np.asarray(jh))
    )
    assert ok_t == ok_j
    np.testing.assert_allclose(f_t, f_j, rtol=1e-9)


def test_generator_draws_are_subsets_of_observed_pairs():
    mask = torch.zeros(40, dtype=torch.bool)
    mask[::3] = True
    idx = TH.sample_subsets(mask, 100, torch.Generator().manual_seed(0))
    assert idx.shape == (100, 6)
    assert bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 6 for row in idx)


def _ba_args(batch, poses, board):
    rng = np.random.default_rng(4)
    gt = tumvi_like_eucm()
    theta0 = gt.params * np.array([1.02, 1.01, 1.0, 1.0, 0.95, 1.05])
    poses0 = poses + rng.normal(size=poses.shape) * 1e-3
    lo = np.array([0, 0, 0, 0, 1e-6, 1e-6])
    hi = np.array([1e4, 1e4, 512, 512, 1, 10.0])
    F = len(poses)
    return (theta0, poses0, board.p3d.astype(np.float64), batch.p2d,
            batch.mask.astype(np.float64), lo, hi, np.ones(6), np.ones(F))


@pytest.mark.parametrize("px_noise", [0.0, 0.3])
def test_ba_solve_matches(px_noise):
    """Same problem, same start: the same optimum.  Noise-free data has
    one exact optimum (theta within 1e-8 relative); with pixel noise the
    cost floor is flat to ~1e-15 relative, so there the costs must agree
    within 1e-9 relative and theta within 1e-7."""
    board = jax_board()
    batch, poses = make_synthetic_batch(
        tumvi_like_eucm(), board, n_frames=10, seed=1, px_noise=px_noise
    )
    args = _ba_args(batch, poses, board)
    rj = JL.ba_solve(jax_project_fn("eucm"), *(jnp.asarray(a) for a in args))
    rt = TL.ba_solve(project_fn("eucm"), *(_t(a) for a in args))
    theta_j = np.asarray(rj.theta)
    if px_noise == 0.0:
        np.testing.assert_allclose(rt.theta.numpy(), theta_j, rtol=1e-8)
        assert float(rt.cost) < 1e-18 and float(rj.cost) < 1e-18
    else:
        np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-9)
        np.testing.assert_allclose(rt.theta.numpy(), theta_j, rtol=1e-7)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-6)


def test_convert_model_grid_fit_matches():
    """EUCM -> UCM grid fit: conversion_grid + the dense lm_solve."""
    from ccrs_tpu.calib.convert import convert_model as jax_convert
    from ccrs_tpu.models import zeros_like_model as jax_zeros
    from ccrs_tpu_torch.calib.convert import convert_model
    from ccrs_tpu_torch.interop import model_from_ref
    from ccrs_tpu_torch.models import zeros_like_model

    src = tumvi_like_eucm()
    jt = jax_zeros("ucm", 512, 512)
    jax_convert(src, jt, 0)
    tt = zeros_like_model("ucm", 512, 512)
    convert_model(model_from_ref(src), tt, 0, device="cpu")
    np.testing.assert_allclose(tt.params, jt.params, rtol=1e-8)


def test_cholesky_nan_on_non_pd():
    M = torch.stack([torch.eye(3, dtype=F64), -torch.eye(3, dtype=F64)])
    x = TL.cholesky_solve_batched_small(M, torch.ones(2, 3, dtype=F64))
    assert torch.equal(x[0], torch.ones(3, dtype=F64))
    assert bool(torch.isnan(x[1]).all())


def test_interop_round_trip():
    board = jax_board()
    batch, _ = make_synthetic_batch(tumvi_like_eucm(), board, n_frames=3, seed=6)
    tb = board_from_ref(board)
    np.testing.assert_array_equal(tb.p3d, board.p3d)
    fb = frame_batch_from_ref(batch)
    np.testing.assert_array_equal(fb.p2d, batch.p2d)
    np.testing.assert_array_equal(fb.mask, batch.mask)
    assert (fb.width, fb.height) == (batch.width, batch.height)
    from ccrs_tpu.types import RvecTvec as JaxRvecTvec

    rt = rvectvec_from_ref(JaxRvecTvec([0.1, -0.2, 3.0], [0.05, 0.0, 0.6]))
    np.testing.assert_array_equal(rt.rvec, [0.1, -0.2, 3.0])
    np.testing.assert_array_equal(
        rt.transform(board.p3d), JaxRvecTvec(rt.rvec, rt.tvec).transform(board.p3d)
    )
