"""``init_and_calibrate_one_camera`` of both packages across the six camera
models and four parameter variants.

Six models x {default, ``one_focal``, ``fixed_focal``,
``disabled_distortion_num=2``} on ``tests/synthetic.py`` batches (16 frames,
0.3 px noise, seed ``crc32(model) % 1000``), the same ``FrameBatch`` into
both packages.  The random choices are injected, so that JAX's threefry
keys against a ``torch.Generator`` cannot decide a case: the port's RANSAC
takes the hypotheses JAX draws from the same keys, attempt by attempt, and
both packages re-pick init frames from one seeded numpy generator.

Tolerance: the medians of the reprojection error agree within 1e-6 px (the
interchange target of BASELINE.md; measured up to 1.4e-7), and a case
fails in one package exactly when it fails in the other.  Two measured
divergences are tested for what they are:

- EUCM with two distortions disabled fits a pinhole to fisheye data
  (median 1.8 px); the cost is so flat that the JAX package's mixed
  float32/float64 solve stops 9.6e-6 px (median) short of the optimum.
  Both solutions are held against a 500-iteration float64 LM: started from
  either it lands on one point, the port is within 1e-6 px of it and its
  cost is no higher than the JAX solution's, which is within 2e-5 px.
- UCM with two distortions disabled (its only distortion gone and one
  intrinsic more) cannot fit: both packages return None through the 2 px
  sanity gate.
"""

import contextlib
import io
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.calib import init_and_calibrate_one_camera as jax_calibrate
from ccrs_tpu.calib import validation as jax_validation
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.models import zeros_like_model as jax_zeros
from ccrs_tpu.types import CalibParams as JaxCalibParams
from ccrs_tpu_torch.calib import init_and_calibrate_one_camera, validation
from ccrs_tpu_torch.calib import initialize as port_initialize
from ccrs_tpu_torch.calib.single import build_bounds, disabled_free_mask
from ccrs_tpu_torch.interop import board_from_ref, frame_batch_from_ref
from ccrs_tpu_torch.models import zeros_like_model
from ccrs_tpu_torch.models.projections import project_fn
from ccrs_tpu_torch.solve.lm import ba_solve
from ccrs_tpu_torch.types import CalibParams
from synthetic import make_synthetic_batch

torch.set_num_threads(2)

MEDIAN_TOL = 1e-6  # px
KEY = 1
N_SAMPLES = 1000

GT = {
    "ucm": ("ucm", [190.5, 190.2, 255.2, 256.1, 0.63]),
    "eucm": ("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]),
    "eucmt": ("eucmt", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046, 0.0012, -0.0008]),
    "kb4": ("kb4", [190.6, 190.3, 255.4, 256.2, 0.012, -0.004, 0.0015, -0.0003]),
    "opencv5": ("opencv5", [420.0, 421.0, 258.0, 254.0, -0.25, 0.06, 0.0008, -0.0005, -0.007]),
    "ftheta": ("ftheta", [190.4, 190.1, 255.5, 255.9, 0.015, -0.006, 0.002, -0.0004, 0.0001]),
}
VARIANTS = {
    "default": {},
    "one_focal": dict(one_focal=True),
    "fixed_focal": "gt",  # fixed_focal = the ground truth's fx
    "disabled2": dict(disabled_distortion_num=2),
}
#: (model, variant) that the sanity gate rejects in both packages
GATED = {("ucm", "disabled2")}
#: (model, variant) held against a long float64 LM (see the module docstring)
FLAT = {("eucm", "disabled2")}


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def jax_draws(key, mask, n_samples):
    """The (n_samples, 6) subsets JAX's RANSAC draws from ``key``
    (``ccrs_tpu/solve/homography.py::radial_distortion_homography``)."""
    keys = jax.random.split(key, n_samples)

    def one(k):
        g = jax.random.gumbel(k, (mask.shape[0],), dtype=jnp.float64)
        return jax.lax.top_k(jnp.where(mask, g, -jnp.inf), 6)[1]

    return np.asarray(jax.vmap(one)(keys))


@contextlib.contextmanager
def port_takes_jax_draws(monkeypatch, seed):
    """Every RANSAC of the port's init takes the hypotheses the JAX package
    draws for the same attempt: the ladder splits its key once per
    attempt and hands the second half to the RANSAC."""
    state = {"key": jax.random.PRNGKey(seed), "calls": 0}
    real = port_initialize.radial_distortion_homography

    def with_draws(p0, p1, mask, n_samples=N_SAMPLES, generator=None, idx=None):
        state["key"], sub = jax.random.split(state["key"])
        state["calls"] += 1
        idx = torch.as_tensor(np.array(jax_draws(sub, jnp.asarray(mask.numpy()), n_samples)))
        return real(p0, p1, mask, n_samples=n_samples, idx=idx)

    monkeypatch.setattr(port_initialize, "radial_distortion_homography", with_draws)
    yield state


def run_both(name, variant, monkeypatch):
    kind, params = GT[name]
    gt = JaxModel(kind, params, 512, 512)
    jb = jax_board()
    batch, _ = make_synthetic_batch(
        gt, jb, n_frames=16, seed=zlib.crc32(name.encode()) % 1000, px_noise=0.3
    )
    kw = VARIANTS[variant]
    if kw == "gt":
        kw = dict(fixed_focal=float(params[0]))
    tb, tbatch = board_from_ref(jb), frame_batch_from_ref(batch)
    want = jax_calibrate(
        jb, batch, jax_zeros(kind), JaxCalibParams(**kw), jax.random.PRNGKey(KEY),
        rng=np.random.default_rng(KEY),
    )
    with port_takes_jax_draws(monkeypatch, KEY) as state:
        got = init_and_calibrate_one_camera(
            tb, tbatch, zeros_like_model(kind), CalibParams(**kw),
            torch.Generator().manual_seed(KEY), rng=np.random.default_rng(KEY), device="cpu",
        )
    assert state["calls"] >= 1
    return (jb, batch, want), (tb, tbatch, got), kw


def long_lm(board, batch, model, rtvecs, disabled, max_iters):
    """A float64 LM of ``max_iters`` iterations from (model, rtvecs) on the
    port's solver: (cost, model with the result's parameters, rtvecs)."""
    from ccrs_tpu_torch.types import RvecTvec

    F = batch.p2d.shape[0]
    poses, fv = np.zeros((F, 6)), np.zeros(F)
    for f, rt in rtvecs.items():
        poses[f], fv[f] = np.concatenate([np.asarray(rt.rvec), np.asarray(rt.tvec)]), 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    lo, hi = build_bounds(model, False)
    free = disabled_free_mask(model, False, disabled)
    lo, hi = np.where(free == 0, -np.inf, lo), np.where(free == 0, np.inf, hi)
    res = ba_solve(
        project_fn(model.name), t(model.params), t(poses), t(board.p3d), t(batch.p2d),
        t(batch.mask), t(lo), t(hi), t(free), t(fv), max_iters=max_iters,
    )
    out = model.copy()
    out.set_params(res.theta.numpy())
    p = res.poses.numpy()
    return float(res.cost), out, {f: RvecTvec(p[f, :3], p[f, 3:]) for f in rtvecs}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(GT))
def test_calibration_matches_reference(name, variant, monkeypatch):
    (jb, batch, want), (tb, tbatch, got), kw = run_both(name, variant, monkeypatch)
    if (name, variant) in GATED:
        assert want is None and got is None
        return
    assert want is not None and got is not None, (want is None, got is None)
    (jm, jrt), (tm, trt) = want, got
    assert sorted(trt) == sorted(jrt)
    _, med_j = _quiet(jax_validation, jb, batch, jm, jrt)
    _, med_t = _quiet(validation, tb, tbatch, tm, trt)
    if kw.get("one_focal") or "fixed_focal" in kw:
        assert tm.params[0] == tm.params[1] and jm.params[0] == jm.params[1]
    if "fixed_focal" in kw:
        assert tm.params[0] == jm.params[0] == kw["fixed_focal"]
    if kw.get("disabled_distortion_num"):
        assert (tm.params[-2:] == 0).all() and (np.asarray(jm.params)[-2:] == 0).all()
    if (name, variant) not in FLAT:
        assert abs(med_t - med_j) < MEDIAN_TOL, (med_t, med_j)
        # focal lengths and principal point; the noise leaves the higher
        # distortion coefficients of FTHETA flat to 5e-4 relative
        np.testing.assert_allclose(tm.params[:4], np.asarray(jm.params)[:4], rtol=1e-6)
        return

    # the flat problem: both against a long float64 LM
    from ccrs_tpu_torch.interop import model_from_ref, rvectvec_from_ref

    jm_t = model_from_ref(jm)
    jrt_t = {f: rvectvec_from_ref(rt) for f, rt in jrt.items()}
    cost_t, _, _ = long_lm(tb, tbatch, tm, trt, 2, 0)
    cost_j, _, _ = long_lm(tb, tbatch, jm_t, jrt_t, 2, 0)
    star_t, m_star_t, rt_star_t = long_lm(tb, tbatch, tm, trt, 2, 500)
    star_j, m_star_j, rt_star_j = long_lm(tb, tbatch, jm_t, jrt_t, 2, 500)
    assert abs(star_t - star_j) <= 1e-11 * star_t, (star_t, star_j)
    np.testing.assert_allclose(m_star_t.params, m_star_j.params, rtol=1e-7, atol=1e-9)
    assert cost_t <= cost_j and cost_t - star_t <= 1e-9 * star_t, (cost_t, cost_j, star_t)
    assert cost_j - star_j <= 1e-8 * star_j, (cost_j, star_j)
    _, med_star = _quiet(validation, tb, tbatch, m_star_j, rt_star_j)
    assert med_t > 1.0  # the pinhole does not fit the fisheye data
    assert abs(med_t - med_star) < MEDIAN_TOL, (med_t, med_star)
    assert abs(med_j - med_star) < 2e-5, (med_j, med_star)
