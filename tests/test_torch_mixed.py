"""The port's mixed-precision solvers against the JAX package's, on the CPU.

The same numpy inputs go through ``ccrs_tpu.solve.lm`` and
``ccrs_tpu_torch.solve.lm`` (results carried across by
``interop.ba_result_from_ref`` / ``multi_ba_result_from_ref``):

- ``ba_solve(jac_f32=True)`` on the problem of
  ``tests/test_lm.py::test_ba_f32_jacobian_polish_fixed_point``: RMS
  within that test's 1e-9 px of the float64 solve, theta within 1e-6
  relative (an O(1e-7) shift by design; the JAX run sits inside 5e-7, the
  port's measures 6.0e-7);
- ``ba_solve_mixed`` and ``ba_solve_multi_mixed`` against the JAX functions
  and against the port's own float64 solve: RMS within ``RMS_TOL`` = 1e-6 px
  (the interchange target).  The float32 stages of XLA and torch round
  differently, so the two polishes start apart and stop where the cost is
  flat: parameters are held to ``FLAT_RTOL`` = 2e-5 relative on noisy data
  (ROADMAP, queue C: on a flat optimum the stop decides the last digits);
- ``CCRS_POLISH_JAC32`` and ``CCRS_POLISH_RTOL`` reach the polish stage;
- ``multi_ba_sharded_mixed`` on eight CPU shards against the single-device
  mixed solve with ``tests/test_parallel.py``'s tolerances (theta 1e-7
  relative, extrinsics 1e-7, ground truth 1e-6);
- queue C's ill-conditioned case (EUCM, ``disabled_distortion_num=2``, 16
  frames) mixed against mixed, both held against a long float64 LM;
- ``solver=`` reaches the solver functions from ``calib_camera``, the retry
  ladder and the joint BA, and the default stays float64.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.calib import init_and_calibrate_one_camera as jax_calibrate
from ccrs_tpu.calib import validation as jax_validation
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.models import zeros_like_model as jax_zeros
from ccrs_tpu.models.projections import project_eucm as jax_project_eucm
from ccrs_tpu.parallel import mesh as jax_mesh
from ccrs_tpu.solve import lm as JL
from ccrs_tpu.types import CalibParams as JaxCalibParams
from ccrs_tpu_torch.calib import init_and_calibrate_one_camera, validation
from ccrs_tpu_torch.calib import multi as port_multi
from ccrs_tpu_torch.calib import single as port_single
from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
from ccrs_tpu_torch.interop import (
    ba_result_from_ref,
    board_from_ref,
    frame_batch_from_ref,
    model_from_ref,
    multi_ba_result_from_ref,
    rvectvec_from_ref,
)
from ccrs_tpu_torch.models import zeros_like_model
from ccrs_tpu_torch.models.projections import project_eucm
from ccrs_tpu_torch.parallel import mesh
from ccrs_tpu_torch.solve import lm as TL
from ccrs_tpu_torch.solve import se3
from ccrs_tpu_torch.types import CalibParams
from synthetic import make_synthetic_batch
from test_lm import _make_ba_case
from test_torch_calib_all_models import (
    GT,
    KEY,
    _quiet,
    jax_board,
    long_lm,
    port_takes_jax_draws,
)
from test_torch_parallel import _multi_case

torch.set_num_threads(2)

F64 = torch.float64
RMS_TOL = 1e-6  # px: mixed against float64, and the port against the JAX package
FLAT_RTOL = 2e-5  # parameters on a noisy (flat) optimum, see the module docstring
LO = [0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6]
HI = [1e4, 1e4, 512.0, 512.0, 1.0, 10.0]


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


def rms(theta, poses, p3d, p2d):
    """Reprojection RMS (px) of a single-camera EUCM solution, float64."""
    proj = torch.func.vmap(
        lambda po: project_eucm(t(theta), se3.transform(po[:3], po[3:], t(p3d)))[0]
    )(t(poses))
    d = np.linalg.norm(proj.numpy() - p2d, axis=-1)
    return float(np.sqrt(np.mean(d**2)))


def multi_rms(res, p3d, p2d):
    """Reprojection RMS (px) of a joint EUCM solution over every camera."""
    sq = []
    for c in range(p2d.shape[0]):
        for f in range(p2d.shape[1]):
            if c == 0:
                rv, tv = res.poses[f, :3], res.poses[f, 3:]
            else:
                rv, tv = se3.compose(res.ext[c, :3], res.ext[c, 3:],
                                     res.poses[f, :3], res.poses[f, 3:])
            proj = project_eucm(res.theta[c], se3.transform(rv, tv, t(p3d)))[0]
            sq.append(((proj.numpy() - p2d[c, f]) ** 2).sum(-1))
    return float(np.sqrt(np.mean(sq)))


def noisy_case():
    """The problem of tests/test_lm.py::test_ba_f32_jacobian_polish_fixed_point."""
    params_gt = np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
    p3d, poses_gt, p2d = _make_ba_case(params_gt, jax_project_eucm, F=8)
    rng = np.random.default_rng(5)
    p2d = p2d + rng.normal(size=p2d.shape) * 0.1  # 0.1 px noise floor
    F, N = p2d.shape[:2]
    theta0 = params_gt * (1 + rng.normal(size=6) * 0.03)
    poses0 = poses_gt + rng.normal(size=(F, 6)) * 0.01
    return (theta0, poses0, p3d, p2d, np.ones((F, N)), LO, HI, np.ones(6), np.ones(F))


def both(name, project_pair, args, convert, **kw):
    jp, tp = project_pair
    want = convert(getattr(JL, name)(jp, *(jnp.asarray(a) for a in args), **kw))
    got = getattr(TL, name)(tp, *(t(a) for a in args), **kw)
    return want, got


EUCM = (jax_project_eucm, project_eucm)


def test_jac_f32_matches_jax_and_the_f64_optimum():
    args = noisy_case()
    p3d, p2d = args[2], args[3]
    want, got = both("ba_solve", EUCM, args, ba_result_from_ref, jac_f32=True)
    ref = TL.ba_solve(project_eucm, *(t(a) for a in args))
    assert got.theta.dtype == F64 and got.n_polish == 0
    # against the port's float64 solve (see the module docstring)
    np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), rtol=1e-6)
    r_ref = rms(ref.theta, ref.poses, p3d, p2d)
    assert abs(rms(got.theta, got.poses, p3d, p2d) - r_ref) < 1e-9
    # against the JAX solve with the same option: two approximate-Jacobian
    # fixed points, each within 1e-6 of the float64 optimum
    np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(), rtol=2e-6)
    assert abs(rms(want.theta, want.poses, p3d, p2d) - r_ref) < 1e-9


def test_jac_f32_is_a_no_op_on_a_float32_solve():
    args = [t(a).to(torch.float32) for a in noisy_case()]
    a = TL.ba_solve(project_eucm, *args, rtol=1e-6)
    b = TL.ba_solve(project_eucm, *args, rtol=1e-6, jac_f32=True)
    assert a.theta.dtype == a.poses.dtype == a.cost.dtype == torch.float32
    assert torch.equal(a.theta, b.theta) and a.n_iters == b.n_iters


@pytest.mark.parametrize("polish_jac_f32", [True, False])
def test_ba_solve_mixed_matches(polish_jac_f32):
    args = noisy_case()
    p3d, p2d = args[2], args[3]
    want, got = both("ba_solve_mixed", EUCM, args, ba_result_from_ref,
                     polish_jac_f32=polish_jac_f32)
    ref = TL.ba_solve(project_eucm, *(t(a) for a in args))
    assert got.theta.dtype == got.poses.dtype == got.cost.dtype == F64
    assert 0 < got.n_polish <= 12 and got.n_iters > got.n_polish
    assert 0 < want.n_polish <= 12
    r_ref = rms(ref.theta, ref.poses, p3d, p2d)
    assert abs(rms(got.theta, got.poses, p3d, p2d) - r_ref) < RMS_TOL
    assert abs(rms(want.theta, want.poses, p3d, p2d) - r_ref) < RMS_TOL
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-9)
    np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), rtol=FLAT_RTOL)
    np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(), rtol=FLAT_RTOL)


def test_ba_solve_mixed_polish_budget():
    """``polish_iters`` bounds the second stage and ``n_iters`` counts both."""
    args = [t(a) for a in noisy_case()]
    res = TL.ba_solve_mixed(project_eucm, *args, polish_iters=2)
    s1 = TL.ba_solve(project_eucm, *(a.to(torch.float32) for a in args), rtol=1e-6)
    assert res.n_polish <= 2 and res.n_iters == s1.n_iters + res.n_polish


def stereo_case(noise):
    args, gt, gt1, ext_gt = _multi_case(
        16, 3, [0.02, -0.015, 0.005, -0.11, 0.002, 0.004],
        [1.01, 1.005, 0.998, 1.002, 0.97, 1.02], (1.02, 0.98), 2e-3,
    )
    if noise:
        rng = np.random.default_rng(11)
        args["p2d"] = args["p2d"] + rng.normal(size=args["p2d"].shape) * noise
    return args, gt, gt1, ext_gt


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_ba_solve_multi_mixed_matches(noise):
    args, gt, gt1, ext_gt = stereo_case(noise)
    want, got = both("ba_solve_multi_mixed", EUCM, list(args.values()),
                     multi_ba_result_from_ref)
    ref = TL.ba_solve_multi(project_eucm, *(t(v) for v in args.values()))
    assert got.theta.dtype == got.ext.dtype == got.poses.dtype == F64
    assert 0 < got.n_polish <= 10 and got.n_iters > got.n_polish
    assert want.n_polish == 0  # the JAX joint result does not count its polish
    r_ref = multi_rms(ref, args["p3d"], args["p2d"])
    assert abs(multi_rms(got, args["p3d"], args["p2d"]) - r_ref) < RMS_TOL
    assert abs(multi_rms(want, args["p3d"], args["p2d"]) - r_ref) < RMS_TOL
    if noise == 0.0:
        # one exact optimum: the ground truth (tests/test_parallel.py)
        np.testing.assert_allclose(got.theta[0].numpy(), gt, rtol=1e-6)
        np.testing.assert_allclose(got.theta[1].numpy(), gt1, rtol=1e-6)
        np.testing.assert_allclose(got.ext[1].numpy(), ext_gt[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(), rtol=1e-6)
    else:
        np.testing.assert_allclose(got.theta.numpy(), ref.theta.numpy(), rtol=FLAT_RTOL)
        np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(), rtol=FLAT_RTOL)


def test_float32_joint_solve_stays_float32():
    args, *_ = stereo_case(0.1)
    res = TL.ba_solve_multi(
        project_eucm, *(t(v).to(torch.float32) for v in args.values()), rtol=1e-6
    )
    assert {res.theta.dtype, res.ext.dtype, res.poses.dtype, res.cost.dtype} == {torch.float32}
    assert res.n_polish == 0


class Recorded(Exception):
    pass


def _record_polish(monkeypatch, name):
    """Replace solver ``name`` in the port: the float32 stage returns its
    start, the polish call raises ``Recorded`` with its keywords."""
    def fake(project_fn, theta0, *rest, **kw):
        if theta0.dtype == torch.float32:
            if name == "ba_solve":
                return TL.BAResult(theta0, rest[0], theta0.sum(), 3)
            return TL.MultiBAResult(theta0, rest[0], rest[1], theta0.sum(), 3)
        raise Recorded(kw)

    monkeypatch.setattr(TL, name, fake)


@pytest.mark.parametrize("env,single,joint", [
    (None, True, False),  # the JAX defaults: float32 J single, float64 J joint
    ("0", False, False),
    ("1", True, True),  # "1" forces the joint polish; the single one is on already
])
def test_polish_jac32_env(monkeypatch, env, single, joint):
    if env is None:
        monkeypatch.delenv("CCRS_POLISH_JAC32", raising=False)
    else:
        monkeypatch.setenv("CCRS_POLISH_JAC32", env)
    _record_polish(monkeypatch, "ba_solve")
    with pytest.raises(Recorded) as e:
        TL.ba_solve_mixed(project_eucm, *(t(a) for a in noisy_case()))
    assert e.value.args[0]["jac_f32"] is single
    assert e.value.args[0]["max_iters"] == 12
    _record_polish(monkeypatch, "ba_solve_multi")
    args, *_ = stereo_case(0.0)
    with pytest.raises(Recorded) as e:
        TL.ba_solve_multi_mixed(project_eucm, *(t(v) for v in args.values()))
    assert e.value.args[0]["jac_f32"] is joint
    assert e.value.args[0]["max_iters"] == 10


def test_polish_jac32_single_ignores_a_forced_on(monkeypatch):
    """As in the JAX package, CCRS_POLISH_JAC32=1 does not override an
    explicit polish_jac_f32=False of the single-camera solver."""
    monkeypatch.setenv("CCRS_POLISH_JAC32", "1")
    _record_polish(monkeypatch, "ba_solve")
    with pytest.raises(Recorded) as e:
        TL.ba_solve_mixed(project_eucm, *(t(a) for a in noisy_case()), polish_jac_f32=False)
    assert e.value.args[0]["jac_f32"] is False


@pytest.mark.parametrize("env,want", [(None, 1e-10), ("1e-14", 1e-14), ("3e-9", 3e-9)])
def test_polish_rtol_env(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("CCRS_POLISH_RTOL", raising=False)
    else:
        monkeypatch.setenv("CCRS_POLISH_RTOL", env)
    assert TL.polish_rtol() == want == JL.polish_rtol()
    _record_polish(monkeypatch, "ba_solve")
    with pytest.raises(Recorded) as e:
        TL.ba_solve_mixed(project_eucm, *(t(a) for a in noisy_case()))
    assert e.value.args[0]["rtol"] == want


def test_sharded_mixed_matches_single_device_mixed():
    """multi_ba_sharded_mixed on eight CPU shards, F = 18 (the padding
    path), against ba_solve_multi_mixed and the JAX sharded function."""
    args, gt, gt1, _ = _multi_case(
        18, 5, [0.01, -0.02, 0.004, -0.1, 0.003, 0.001],
        [1.012, 1.003, 0.999, 1.001, 0.98, 1.01], (1.02, 0.985), 1e-3,
    )
    targs = [t(v) for v in args.values()]
    ref = TL.ba_solve_multi_mixed(project_eucm, *targs)
    with mesh.default_mesh(["cpu"] * 8):
        res = mesh.multi_ba_sharded_mixed(project_eucm, *targs)
    want = multi_ba_result_from_ref(jax_mesh.multi_ba_sharded_mixed(
        jax_project_eucm, *(jnp.asarray(v) for v in args.values())
    ))
    assert res.poses.shape == (18, 6) and res.theta.dtype == F64
    assert 0 < res.n_polish <= 10 and res.n_iters > res.n_polish
    np.testing.assert_allclose(res.theta.numpy(), ref.theta.numpy(), rtol=1e-7)
    np.testing.assert_allclose(res.ext.numpy(), ref.ext.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.theta.numpy(), want.theta.numpy(), rtol=1e-7)
    np.testing.assert_allclose(res.ext.numpy(), want.ext.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.theta[0].numpy(), gt, rtol=1e-6)
    np.testing.assert_allclose(res.theta[1].numpy(), gt1, rtol=1e-6)


def test_mesh_solvers_take_jac_f32():
    """make_ba_solver / make_multi_ba_solver with jac_f32 land on the
    float64 optimum of the noiseless problems (tests/test_parallel.py's
    1e-6 against the ground truth)."""
    args, gt, gt1, _ = stereo_case(0.0)
    devs = [torch.device("cpu")] * 4
    res = mesh.make_multi_ba_solver(project_eucm, devs, jac_f32=True)(
        *(t(v) for v in args.values())
    )
    np.testing.assert_allclose(res.theta[0].numpy(), gt, rtol=1e-6)
    np.testing.assert_allclose(res.theta[1].numpy(), gt1, rtol=1e-6)
    single = (args["theta0"][0], args["poses0"], args["p3d"], args["p2d"][0],
              args["w"][0], LO, HI, np.ones(6), np.ones(16))
    res = mesh.make_ba_solver(project_eucm, devs, jac_f32=True)(*(t(a) for a in single))
    np.testing.assert_allclose(res.theta.numpy(), gt, rtol=1e-6)


@pytest.fixture(scope="module")
def rig3():
    """``bench_multicam.py``'s rig at 3 cameras x 40 frames, on the CPU."""
    from ccrs_tpu_torch.testdata import rig_problem

    return rig_problem(3, 40, seed=1, device="cpu")


def test_joint_float32_jacobians_fail_near_pi_in_both_packages(rig3):
    """Where a joint ``jac_f32=True`` solve loses its way.  The rig's board
    faces the cameras, so a frame's pose can be a rotation by almost pi, and
    the log map's derivative in ``se3.compose`` cancels there in float32:
    frame 0's composed angle is 3.1400 rad and the float32 Jacobian of the
    composition is off by 61 in a component (the median frame by 1e-4).
    The JAX package's float32 Jacobian is off by the same amount on the
    same frame, so the port computes what the reference does.  Camera 0,
    which composes nothing, has float32 Jacobians within 1e-6 of the
    float64 ones; the residual beside them is the float64 one bit for bit."""
    from ccrs_tpu.solve import se3 as jax_se3

    theta, ext, poses, p3d, p2d = rig3["args"][:5]

    def compose(e, p):
        return torch.cat(se3.compose(e[:3], e[3:], p[:3], p[3:]))

    def jax_compose(e, p):
        return jnp.concatenate(jax_se3.compose(e[:3], e[3:], p[:3], p[3:]))

    jac = torch.func.vmap(torch.func.jacfwd(compose, argnums=(0, 1)), in_dims=(None, 0))
    jax_jac = jax.vmap(jax.jacfwd(jax_compose, argnums=(0, 1)), in_axes=(None, 0))
    exact = jac(ext[1], poses)
    mine = jac(ext[1].to(torch.float32), poses.to(torch.float32))
    theirs = jax_jac(jnp.asarray(ext[1].numpy(), jnp.float32),
                     jnp.asarray(poses.numpy(), jnp.float32))
    for k in range(2):
        err = (exact[k] - mine[k]).abs().amax(dim=(1, 2)).numpy()
        jax_err = np.abs(exact[k].numpy() - np.asarray(theirs[k])).max(axis=(1, 2))
        assert err.argmax() == jax_err.argmax() == 0
        assert err[0] > 10 and abs(err[0] - jax_err[0]) < 0.01 * jax_err[0]
        assert np.median(err) < 1e-3 and np.median(jax_err) < 1e-3
    angle = torch.linalg.norm(compose(ext[1], poses[0])[:3])
    assert abs(float(angle) - np.pi) < 2e-3

    full = TL.multi_frame_fns(project_eucm, p3d, False, 3)
    half = TL.multi_frame_fns(project_eucm, p3d, False, 3, jac_f32=True)
    for c in range(3):
        want, r_want = full[c][1](theta[c], ext[c], poses, p2d[c])
        got, r_got = half[c][1](theta[c], ext[c], poses, p2d[c])
        assert torch.equal(r_got, r_want) and {J.dtype for J in got} == {F64}
        if c == 0:
            for a, b in zip(want, got):
                assert float((a - b).abs().max()) <= 1e-6 * max(float(a.abs().max()), 1.0)


def test_joint_jac_f32_stalls_as_the_jax_solve_does(rig3):
    """``ba_solve_multi(jac_f32=True)`` on the rig against the JAX function
    with the same option.  Both take the same bad first step (cost 441.0
    against 439.6, the float64 step reaches 281.7), and both stop well above
    the float64 optimum of 0.0992 px (the port at 0.111 px, the JAX package
    at 0.120 px; on an H100 the port stops at 0.120 px).  The trajectories
    part after that step, so the end points are held only to that band.
    This is why the joint polish keeps float64 Jacobians by default."""
    from ccrs_tpu_torch.testdata import rig_errors

    args = rig3["args"]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ref = TL.ba_solve_multi(project_eucm, *args)
    r_ref = rig_errors(rig3, ref)["rms_px"]
    assert 0.07 < r_ref < 0.13

    step = TL.ba_solve_multi(project_eucm, *args, max_iters=1, jac_f32=True)
    jax_step = JL.ba_solve_multi(jax_project_eucm, *jargs, max_iters=1, jac_f32=True)
    exact_step = TL.ba_solve_multi(project_eucm, *args, max_iters=1)
    np.testing.assert_allclose(float(step.cost), float(jax_step.cost), rtol=0.01)
    assert float(step.cost) > 1.3 * float(exact_step.cost)

    got = TL.ba_solve_multi(project_eucm, *args, jac_f32=True)
    want = multi_ba_result_from_ref(JL.ba_solve_multi(jax_project_eucm, *jargs, jac_f32=True))
    for res in (got, want):
        r = rig_errors(rig3, res)["rms_px"]
        assert r_ref + 5e-3 < r < r_ref + 0.04, r
        assert res.n_iters > ref.n_iters


def test_flat_eucm_case_mixed_against_mixed(monkeypatch):
    """Queue C's ill-conditioned case with both packages on the mixed
    route: a pinhole fit to fisheye data (median above 1 px), whose flat
    cost lets each mixed solve stop short of the optimum by its own
    margin (measured: the port 1.4e-5 px in median, the JAX package
    9.6e-6).  Like against like, it is the mixed route and not the package
    that stops short: both are held against a 500-iteration float64 LM
    started from their solutions, which lands on one point, to the 2e-5 px
    that tests/test_torch_calib_all_models.py holds the JAX package to,
    and so against each other."""
    kind, params = GT["eucm"]
    jb = jax_board()
    batch, _ = make_synthetic_batch(
        JaxModel(kind, params, 512, 512), jb, n_frames=16,
        seed=zlib.crc32(b"eucm") % 1000, px_noise=0.3,
    )
    kw = dict(disabled_distortion_num=2)
    tb, tbatch = board_from_ref(jb), frame_batch_from_ref(batch)
    jm, jrt = jax_calibrate(
        jb, batch, jax_zeros(kind), JaxCalibParams(**kw), jax.random.PRNGKey(KEY),
        rng=np.random.default_rng(KEY),
    )
    with port_takes_jax_draws(monkeypatch, KEY):
        tm, trt = init_and_calibrate_one_camera(
            tb, tbatch, zeros_like_model(kind), CalibParams(**kw),
            torch.Generator().manual_seed(KEY), rng=np.random.default_rng(KEY),
            device="cpu", solver="mixed",
        )
    assert sorted(trt) == sorted(jrt)
    _, med_j = _quiet(jax_validation, jb, batch, jm, jrt)
    _, med_t = _quiet(validation, tb, tbatch, tm, trt)
    jm_t = model_from_ref(jm)
    jrt_t = {f: rvectvec_from_ref(rt) for f, rt in jrt.items()}
    star_t, m_star, rt_star = long_lm(tb, tbatch, tm, trt, 2, 500)
    star_j, _, _ = long_lm(tb, tbatch, jm_t, jrt_t, 2, 500)
    assert abs(star_t - star_j) <= 1e-11 * star_t, (star_t, star_j)
    _, med_star = _quiet(validation, tb, tbatch, m_star, rt_star)
    assert med_t > 1.0
    assert abs(med_t - med_star) < 2e-5, (med_t, med_star)
    assert abs(med_j - med_star) < 2e-5, (med_j, med_star)
    assert abs(med_t - med_j) < 2e-5, (med_t, med_j)


def test_solver_argument_reaches_the_solvers(monkeypatch):
    """``solver="mixed"`` takes ba_solve_mixed with the caller's
    polish_iters; the default and ``"f64"`` take ba_solve; any other name
    raises."""
    board = board_from_ref(jax_board())
    batch, _ = make_synthetic_batch(
        JaxModel(*GT["eucm"], 512, 512), jax_board(), n_frames=6, seed=3, px_noise=0.1
    )
    tbatch = frame_batch_from_ref(batch)
    cam = model_from_ref(JaxModel(*GT["eucm"], 512, 512))
    calls = []
    real_mixed, real_f64 = port_single.ba_solve_mixed, port_single.ba_solve

    def mixed(*a, **k):
        calls.append(("mixed", k.get("polish_iters")))
        return real_mixed(*a, **k)

    def f64(*a, **k):
        calls.append(("f64", None))
        return real_f64(*a, **k)

    monkeypatch.setattr(port_single, "ba_solve_mixed", mixed)
    monkeypatch.setattr(port_single, "ba_solve", f64)
    kw = dict(xy_same_focal=False, disabled_distortions=0, fixed_focal=False, device="cpu")
    a = port_single.calib_camera(board, tbatch, cam, **kw)
    b = port_single.calib_camera(board, tbatch, cam, solver="f64", polish_iters=3, **kw)
    c = port_single.calib_camera(board, tbatch, cam, solver="mixed", polish_iters=3, **kw)
    assert calls == [("f64", None), ("f64", None), ("mixed", 3)]
    np.testing.assert_array_equal(a[0].params, b[0].params)
    np.testing.assert_allclose(c[0].params, a[0].params, rtol=FLAT_RTOL)
    with pytest.raises(ValueError, match="solver must be one of"):
        port_single.calib_camera(board, tbatch, cam, solver="f32", **kw)

    calls.clear()
    calibrate_camera_with_retries(
        board, tbatch, zeros_like_model("eucm"), CalibParams(),
        torch.Generator().manual_seed(0), device="cpu", solver="mixed",
    )
    # the two-frame init calibration and the final solve, both mixed
    assert len(calls) >= 2 and all(c == ("mixed", 12) for c in calls)


@pytest.mark.parametrize("n_mesh,solver,want", [
    (1, "f64", "ba_solve_multi"),
    (1, "mixed", "ba_solve_multi_mixed"),
    (8, "f64", "multi_ba_sharded"),
    (8, "mixed", "multi_ba_sharded_mixed"),
])
def test_joint_ba_solver_route(monkeypatch, n_mesh, solver, want):
    from ccrs_tpu_torch.types import RvecTvec

    args, gt, gt1, ext_gt = stereo_case(0.0)
    C, F, N = args["w"].shape
    board = board_from_ref(jax_board())
    taken = []
    for name in ("ba_solve_multi", "ba_solve_multi_mixed", "multi_ba_sharded",
                 "multi_ba_sharded_mixed"):
        real = getattr(port_multi, name)
        monkeypatch.setattr(
            port_multi, name,
            lambda *a, _n=name, _r=real, **k: (taken.append(_n), _r(*a, **k))[1],
        )
    # a two-camera rig seen through the default board: observations from
    # the port's own projection
    rng = np.random.default_rng(2)
    cams, rtvecs, batches = [], [], []
    ext = [RvecTvec.identity(), RvecTvec(ext_gt[1, :3], ext_gt[1, 3:])]
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.models import GenericModel

    poses = {f: RvecTvec(rng.normal(size=3) * 0.15,
                         np.array([-0.2, 0.2, 0.8]) + rng.normal(size=3) * 0.03)
             for f in range(F)}
    for c, params in enumerate((gt, gt1)):
        m = GenericModel("eucm", params, 512, 512)
        rt = {f: ext[c].compose(p) for f, p in poses.items()}
        p2d = np.stack([
            project_eucm(t(params), t(rt[f].transform(board.p3d)))[0].numpy()
            for f in range(F)
        ])
        batches.append(FrameBatch(np.arange(F, dtype=np.int64), p2d,
                                  np.ones(p2d.shape[:2], bool), 512, 512))
        m2 = m.copy()
        m2.set_params(params * (1.01 if c == 0 else 0.99))
        cams.append(m2)
        rtvecs.append(rt)
    with mesh.default_mesh(["cpu"] * n_mesh):
        out = port_multi.calib_all_camera_with_extrinsics(
            board, cams, ext, rtvecs, batches, False, 0, False, device="cpu",
            solver=solver,
        )
    assert taken == [want]
    models, t_i_0, _ = out
    np.testing.assert_allclose(models[0].params, gt, rtol=1e-6)
    np.testing.assert_allclose(models[1].params, gt1, rtol=1e-6)
    with pytest.raises(ValueError, match="solver must be one of"):
        port_multi.calib_all_camera_with_extrinsics(
            board, cams, ext, rtvecs, batches, False, 0, False, device="cpu",
            solver="mixd",
        )


def test_interop_carries_solver_results():
    args = noisy_case()
    res = JL.ba_solve_mixed(jax_project_eucm, *(jnp.asarray(a) for a in args))
    got = ba_result_from_ref(res)
    assert isinstance(got, TL.BAResult) and got.theta.dtype == F64
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(res.theta))
    np.testing.assert_array_equal(got.poses.numpy(), np.asarray(res.poses))
    assert got.n_iters == int(res.n_iters) and got.n_polish == int(res.n_polish)
    margs, *_ = stereo_case(0.0)
    mres = JL.ba_solve_multi(jax_project_eucm, *(jnp.asarray(v) for v in margs.values()))
    mgot = multi_ba_result_from_ref(mres)
    assert isinstance(mgot, TL.MultiBAResult) and mgot.n_polish == 0
    np.testing.assert_array_equal(mgot.ext.numpy(), np.asarray(mres.ext))
    assert mgot.n_iters == int(mres.n_iters)


@pytest.mark.parametrize("name", ["ucm", "eucm", "eucmt", "kb4", "opencv5", "ftheta"])
def test_float32_jacobians_stay_float32(name):
    """The float32 stage differentiates every model in float32: forward
    mode gives a 0-dim float32 tensor times a Python float a float64
    tangent, which ``pts @ R.mT`` would refuse; ``se3`` keeps its
    per-rotation scalars 1-dim for that.  The float32 Jacobians of the
    chained reprojection agree with the float64 ones within 2e-6 of each
    block's largest entry."""
    from torch.func import jacfwd, vmap

    from ccrs_tpu_torch.models.projections import project_fn

    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(9, 3, generator=gen) * 0.1
    pts[:, 2] = 0
    poses = torch.cat([torch.randn(4, 3, generator=gen) * 0.2,
                       torch.tensor([0.0, 0.0, 1.0]) + torch.randn(4, 3, generator=gen) * 0.05], 1)
    ext = torch.randn(6, generator=gen) * 0.05
    k = zeros_like_model(name).n_params
    theta = torch.zeros(k)
    theta[:4] = torch.tensor([200.0, 200.0, 256.0, 256.0])
    if name in ("ucm", "eucm", "eucmt"):
        theta[4] = 0.6
    if name in ("eucm", "eucmt"):
        theta[5] = 1.0
    theta[4:] += 0.01
    proj = project_fn(name)

    def resid(th, e, po):
        rv, tv = se3.compose(e[:3], e[3:], po[:3], po[3:])
        return proj(th, se3.transform(rv, tv, pts.to(th.dtype)))[0]

    jac = vmap(jacfwd(resid, argnums=(0, 1, 2)), in_dims=(None, None, 0))
    j32 = jac(theta, ext, poses)
    j64 = jac(theta.double(), ext.double(), poses.double())
    for a, b in zip(j32, j64):
        assert a.dtype == torch.float32 and b.dtype == F64
        assert float((a.double() - b).abs().max() / b.abs().max()) < 2e-6
