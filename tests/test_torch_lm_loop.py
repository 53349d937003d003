"""The LM's damping loop on the device and calibration's graphed entry points
(``ccrs_tpu_torch/solve/lm.py``, ``graphs.call`` in ``calib/``), on the CPU.

The graphed code paths run here on the eager stand-ins of ``graphs.get``
(``graphs.active`` patched to take the CPU, as ``tests/test_torch_graphs.py``
does; a CPU tensor never reaches a capture), with ``lm.CHUNK_ITERS``
patched to the chunk length under test.  ``tests/test_torch_cuda.py`` holds
the captured graphs on the card.

- The device loop in chunks of K in {1, 3, 8} iterations against the
  per-iteration loop (the eager path: one host read per iteration): theta,
  poses, extrinsics, cost and ``n_iters`` equal bit for bit, for
  ``lm_solve``, ``ba_solve``, ``ba_solve_multi``, the mixed solvers, the
  frame-sharded route (``mesh_rules``) and the calibration entry points
  (``try_init_camera``, ``calib_camera`` cold, warm and with
  ``skip_pose_init``), on problems that stop by ``rtol``, by the stall
  rule, by a vanished gradient (joint) and at ``max_iters`` (6, 7 and 8: at
  K = 3 the 6th iteration ends a chunk and the 7th lies in one's middle, at
  K = 8 the 8th ends one); each stop's rule is checked on the final state.
- The same solves through the graphed path against the JAX package, at the
  tolerances of ``tests/test_torch_solve.py``, ``test_torch_mixed.py``,
  ``test_torch_multicam.py`` and ``test_torch_parallel.py`` (those tests,
  run again with the graphed path on), and with JAX's iteration counts
  equal where the stop does not fall on a flat optimum: a loose ``rtol``,
  ``max_iters``, the joint solve's vanished gradient on noise-free data,
  and the sharded solve.  On noisy data a 1e-14 relative-decrease stop sits
  in the optimum's rounding noise (flat to ~1e-15 relative: ROADMAP C), so
  there the two packages stop at other iterations, as they did before the
  loop moved to the device; those cases are held to the cost and
  parameter tolerances only.
- ``init_ucm`` with JAX's draws against ``_try_init_device``: ``ok`` equal,
  the UCM parameters within ``INIT_RTOL``; ``pose_init`` against
  ``_pose_init_device`` within ``POSE_ATOL``; ``calib_camera_solve``
  (cold, warm, ``skip_pose_init``; ``solver="mixed"``, the JAX graph's
  solver) against ``_calib_camera_device``: frame masks equal, RMS within
  ``RMS_TOL`` px and theta within ``FLAT_RTOL``.
- The warm-up thread never reaches a capture: every graph it asks for is
  an eager stand-in (its ``no_capture`` scope), while another thread's
  solves keep the graphed path.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mixed as TMX
import test_torch_multicam as TMC
import test_torch_parallel as TPA
import test_torch_solve as TSO
from ccrs_tpu.calib import initialize as JI
from ccrs_tpu.calib import single as JS
from ccrs_tpu.models.projections import project_eucm as jax_project_eucm
from ccrs_tpu.models.projections import project_fn as jax_project_fn
from ccrs_tpu.models.projections import unproject_fn as jax_unproject_fn
from ccrs_tpu.solve import lm as JL
from ccrs_tpu_torch import graphs
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib import calib_camera, initialize, single
from ccrs_tpu_torch.calib.convert import convert_model
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.calib.prewarm import prewarm_calibration
from ccrs_tpu_torch.interop import board_from_ref
from ccrs_tpu_torch.models import GenericModel, zeros_like_model
from ccrs_tpu_torch.models.projections import project_eucm, project_fn, unproject_fn
from ccrs_tpu_torch.parallel import mesh
from ccrs_tpu_torch.solve import lm as TL
from ccrs_tpu_torch.types import CalibParams
from synthetic import make_synthetic_batch, tumvi_like_eucm
from test_torch_calib_all_models import jax_draws

torch.set_num_threads(2)

F64 = torch.float64
KS = (1, 3, 8)
RMS_TOL = 1e-6  # px, the interchange target (BASELINE.md)
FLAT_RTOL = 2e-5  # theta on a noisy (flat) optimum, as tests/test_torch_mixed.py
INIT_RTOL = 1e-6  # the init's UCM parameters, port against JAX with the same draws
POSE_ATOL = 1e-9  # pose init (rvec | tvec), port against JAX
LO = [0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6]
HI = [1e4, 1e4, 512.0, 512.0, 1.0, 10.0]


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


@pytest.fixture
def graphed(monkeypatch):
    """The graphed code paths on the CPU: ``graphs.active`` takes every
    device outside ``eager()`` and ``no_capture()``; ``graphs.get`` still
    hands a CPU tensor the eager stand-in (no capture)."""
    def no_capture(*a, **k):
        raise AssertionError("a CPU tensor reached a capture")

    monkeypatch.setattr(graphs, "active", lambda where: not graphs._off())
    monkeypatch.setattr(graphs, "_capture", no_capture)


@pytest.fixture
def loops(monkeypatch):
    """Every device loop's (graphed, chunk length, final scalars: lam,
    cost, rejections, accepted, n_iters, stop flag), in call order."""
    seen = []
    real = TL._device_loop

    def record(*args, **kw):
        out, it = real(*args, **kw)
        lam, cost, rej, acc, n, done = out[-6:]
        seen.append(dict(graphed=kw["graphed"], k=TL.CHUNK_ITERS if kw["graphed"] else 1,
                         lam=float(lam), rej=int(rej), acc=bool(acc), n=int(n),
                         done=bool(done)))
        return out, it

    monkeypatch.setattr(TL, "_device_loop", record)
    return seen


def stop_rule(s, max_iters, max_rejects=5):
    """The rule that ended a loop, from its final scalars."""
    assert s["done"]
    if s["rej"] >= (max_rejects if s["acc"] else 3 * max_rejects) and s["lam"] >= 1e2:
        return "stall"
    if s["n"] >= max_iters:
        return "max_iters"
    return "converged"  # an accepted step's rtol, or a vanished gradient


# --------------------------------------------------------------------------
# problems
# --------------------------------------------------------------------------


def synthetic_args(noise, F=10, seed=1):
    """``tests/test_torch_solve.py``'s single-camera problem."""
    board = TSO.jax_board()
    batch, poses = make_synthetic_batch(tumvi_like_eucm(), board, n_frames=F, seed=seed,
                                        px_noise=noise)
    return TSO._ba_args(batch, poses, board)


def calib_case(n_frames=12, seed=3):
    """A port FrameBatch of a TUM-VI-like EUCM camera (0.3 px noise) and
    its ground-truth poses."""
    from ccrs_tpu.board import create_default_6x6_board as jax_board
    from ccrs_tpu_torch.interop import frame_batch_from_ref

    jb = jax_board()
    batch, poses = make_synthetic_batch(tumvi_like_eucm(), jb, n_frames=n_frames, seed=seed,
                                        px_noise=0.3)
    return jb, batch, board_from_ref(jb), frame_batch_from_ref(batch), poses


def seed_model():
    m = GenericModel("eucm", np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
                     * [1.02, 0.99, 1.0, 1.0, 0.97, 1.02], 512, 512)
    return m


def _ba(args, **kw):
    return TL.ba_solve(project_eucm, *(t(a) for a in args), **kw)


def _multi(args, **kw):
    return TL.ba_solve_multi(project_eucm, *(t(v) for v in args.values()), **kw)


def _mesh_ba(cpus):
    gt, p3d, poses_gt, p2d = TPA._case(F=24, seed=2)
    poses0, w, fv = poses_gt + 0.004, np.ones(p2d.shape[:2]), np.ones(p2d.shape[0])
    (p2d_p, w_p, poses_p, fv_p), _ = mesh.pad_frames([t(p2d), t(w), t(poses0), t(fv)],
                                                     len(cpus))
    return mesh.make_ba_solver(project_eucm, cpus)(
        t(gt * 1.03), poses_p, t(p3d), p2d_p, w_p, t(LO), t(HI), torch.ones(6, dtype=F64),
        fv_p)


def _mesh_multi(cpus):
    args, *_ = TMX.stereo_case(0.1)
    return mesh.multi_ba_sharded(project_eucm, *(t(v) for v in args.values()), mesh=cpus)


def _convert():
    src = GenericModel("ucm", [190.5, 190.2, 255.2, 256.1, 0.63], 512, 512)
    tgt = zeros_like_model("kb4", 512, 512)
    convert_model(src, tgt, device="cpu")
    return tgt


def _init():
    _, _, board, batch, _ = calib_case()
    gen = torch.Generator().manual_seed(3)
    f0, f1 = initialize.find_best_two_frames(batch)
    model = initialize.try_init_camera(board, batch, f0, f1, gen, device="cpu")
    assert model is not None
    return model


def _calib(variant):
    _, _, board, batch, poses = calib_case()
    kw = {}
    if variant != "cold":
        valid = np.ones(batch.n_frames)
        if variant == "warm":
            valid[::3] = 0.0  # a third of the frames from the PnP init
        kw = dict(warm_poses=poses + 1e-3, warm_valid=valid,
                  skip_pose_init=variant == "skip_pose_init")
    return calib_camera(board, batch, seed_model(), False, 0, False, device="cpu", **kw)


noisy = TMX.noisy_case

#: name -> (solve, {loop index: (stop rule, max_iters)}): the rule that
#: ends the named loops of the solve
PROBLEMS = {
    "lm_solve grid fit": (_convert, {0: ("stall", 60)}),
    "ba_solve rtol": (lambda: _ba(synthetic_args(0.3)), {0: ("converged", 60)}),
    "ba_solve stall": (lambda: _ba(noisy(), rtol=0.0), {0: ("stall", 60)}),
    "ba_solve max_iters 6": (lambda: _ba(noisy(), rtol=0.0, max_iters=6),
                             {0: ("max_iters", 6)}),
    "ba_solve max_iters 7": (lambda: _ba(noisy(), rtol=0.0, max_iters=7),
                             {0: ("max_iters", 7)}),
    "ba_solve max_iters 8": (lambda: _ba(noisy(), rtol=0.0, max_iters=8),
                             {0: ("max_iters", 8)}),
    "ba_solve_multi gradient": (lambda: _multi(TMX.stereo_case(0.0)[0], rtol=0.0),
                                {0: ("converged", 60)}),
    "ba_solve_multi rtol": (lambda: _multi(TMX.stereo_case(0.1)[0]), {0: ("converged", 60)}),
    "ba_solve_mixed": (lambda: TL.ba_solve_mixed(project_eucm, *(t(a) for a in noisy())), {}),
    "ba_solve_multi_mixed": (lambda: TL.ba_solve_multi_mixed(
        project_eucm, *(t(v) for v in TMX.stereo_case(0.1)[0].values())), {}),
    "sharded ba, mesh rules": (lambda: _mesh_ba([torch.device("cpu")] * 4), {}),
    "sharded joint ba, mesh rules": (lambda: _mesh_multi([torch.device("cpu")] * 3), {}),
    "try_init_camera": (_init, {}),
    "calib_camera cold": (lambda: _calib("cold"), {}),
    "calib_camera warm": (lambda: _calib("warm"), {}),
    "calib_camera skip_pose_init": (lambda: _calib("skip_pose_init"), {}),
}


def bits(out):
    """Every number of a solver result, as tensors / arrays / ints."""
    if isinstance(out, GenericModel):
        return [out.params]
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], GenericModel):
        model, rtvecs = out
        return [model.params, sorted(rtvecs)] + [
            np.concatenate([rtvecs[f].rvec, rtvecs[f].tvec]) for f in sorted(rtvecs)]
    return list(out)


def assert_same_bits(got, want):
    got, want = bits(got), bits(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), (g, w)
        elif isinstance(g, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (g, w)
        else:
            assert g == w


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_device_loop_equals_the_per_iteration_loop(name, k, loops, monkeypatch):
    """Chunks of K iterations (graphed path) against one iteration per host
    read (eager path): the same bits, the same ``n_iters``, the stop rule
    the problem was built for, and the masked iterations only after a
    stop."""
    solve, rules = PROBLEMS[name]
    want = solve()
    eager = list(loops)
    assert eager and not any(s["graphed"] for s in eager)
    loops.clear()
    with monkeypatch.context() as m:
        m.setattr(graphs, "active", lambda where: not graphs._off())
        m.setattr(TL, "CHUNK_ITERS", k)
        got = solve()
    assert_same_bits(got, want)
    assert [s["n"] for s in loops] == [s["n"] for s in eager]
    assert all(s["graphed"] and s["k"] == k for s in loops)
    for i, (rule, max_iters) in rules.items():
        assert stop_rule(loops[i], max_iters) == rule, loops[i]


def test_max_iters_cases_end_chunks_and_stop_inside_them():
    """At K = 3 the 6-iteration solve stops on a chunk's last iteration and
    the 7-iteration one in a chunk's middle; at K = 8 the 8-iteration one
    ends its chunk."""
    assert 6 % 3 == 0 and 7 % 3 != 0 and 8 % 8 == 0 and 7 % 8 != 0
    for m in (6, 7, 8):
        assert _ba(noisy(), rtol=0.0, max_iters=m).n_iters == m


def test_chunk_of_a_stopped_state_changes_no_bit():
    """A chunk run on a state whose stop flag is set leaves every state
    tensor as it was, bit for bit (the while-loop's semantics)."""
    args = [t(a) for a in noisy()]
    res = TL.ba_solve(project_eucm, *args, rtol=0.0, max_iters=3)
    static = (project_eucm, False, TL.LMOptions(max_iters=3, rtol=0.0), (torch.device("cpu"),),
              False, False)
    theta0, poses0, p3d, p2d, w, lo, hi, free, fv = args
    problem = (lo, hi, free, p3d, p2d, w * fv[:, None], fv)
    state = [res.theta.clone(), res.poses.clone(), *TL._lm_scalars(static[2], res.cost)]
    state[6] = torch.ones((), dtype=torch.int64) * 3  # it = max_iters
    state[7] = torch.ones((), dtype=torch.bool)  # stopped
    before = [s.clone() for s in state]
    status = TL._ba_chunk(*static, 5, *problem, *state)
    assert status.tolist() == [1, 3]
    for a, b in zip(state, before):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the graphed path against the JAX package
# --------------------------------------------------------------------------


#: existing parity tests, run again with the graphed path on
EXISTING = {
    "ba_solve noise-free": lambda: TSO.test_ba_solve_matches(0.0),
    "ba_solve noisy": lambda: TSO.test_ba_solve_matches(0.3),
    "convert grid fit": TSO.test_convert_model_grid_fit_matches,
    "ba_solve jac_f32": TMX.test_jac_f32_matches_jax_and_the_f64_optimum,
    "ba_solve_mixed": lambda: TMX.test_ba_solve_mixed_matches(True),
    "ba_solve_multi_mixed noise-free": lambda: TMX.test_ba_solve_multi_mixed_matches(0.0),
    "ba_solve_multi_mixed noisy": lambda: TMX.test_ba_solve_multi_mixed_matches(0.1),
    "init_camera_extrinsic": TMC.test_init_camera_extrinsic_matches_reference,
    "joint ba 2 cameras": lambda: TMC.test_joint_ba_matches_reference(2),
}


@pytest.mark.parametrize("name", list(EXISTING))
def test_existing_parity_through_the_graphed_path(name, graphed, loops):
    """The existing parity tests against the JAX package, each at its own
    tolerance, with every solve through the device loop in chunks."""
    EXISTING[name]()
    assert loops and all(s["graphed"] and s["k"] == TL.CHUNK_ITERS for s in loops)


#: (name, JAX solve, port solve): stops that do not fall on a flat optimum
JAX_COUNTS = {
    "ba_solve loose rtol": ("ba_solve", noisy, dict(rtol=1e-6)),
    "ba_solve max_iters 7": ("ba_solve", noisy, dict(rtol=0.0, max_iters=7)),
    "ba_solve_multi gradient": ("ba_solve_multi", lambda: list(TMX.stereo_case(0.0)[0].values()),
                                dict(rtol=0.0)),
    "ba_solve_multi noise-free": ("ba_solve_multi",
                                  lambda: list(TMX.stereo_case(0.0)[0].values()), {}),
}


@pytest.mark.parametrize("name", list(JAX_COUNTS))
def test_graphed_solves_take_jax_iteration_counts(name, graphed):
    """Through the graphed path: JAX's iteration count exactly, the cost
    within 1e-9 relative and theta within 1e-7 (``tests/test_torch_solve.py``'s
    tolerances for a noisy problem)."""
    fn, make, kw = JAX_COUNTS[name]
    args = make()
    want = getattr(JL, fn)(jax_project_eucm, *(jnp.asarray(a) for a in args), **kw)
    got = getattr(TL, fn)(project_eucm, *(t(a) for a in args), **kw)
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=1e-7)


def test_graphed_sharded_route_matches_jax(graphed, loops):
    """``make_ba_solver`` over 8 CPU shards (``mesh_rules``) through the
    graphed path against the JAX package's ``make_ba_solver``
    (``tests/test_torch_parallel.py``'s tolerances), with its iteration
    count; then the joint BA's sharded routes."""
    from ccrs_tpu.parallel import mesh as jax_mesh

    with mesh.default_mesh(TPA.CPU8):
        TPA.test_full_sharded_solve_matches_jax(None)
        TPA.test_sharded_multicam_solve_matches_jax(None)
        TPA.test_multi_ba_sharded_matches_jax_mixed(None)
        gt, p3d, poses_gt, p2d = TPA._case(F=24, seed=2)
        poses0, w, fv = poses_gt + 0.004, np.ones(p2d.shape[:2]), np.ones(p2d.shape[0])
        jm = jax_mesh.make_mesh()
        sh = jax_mesh.sharded_frame_sharding(jm)
        (jp2d, jw, jposes, jfv), _ = jax_mesh.pad_frames(
            [jnp.asarray(p2d), jnp.asarray(w), jnp.asarray(poses0), jnp.asarray(fv)], 8)
        want = jax_mesh.make_ba_solver(jax_project_eucm, jm)(
            jnp.asarray(gt * 1.03), jax.device_put(jposes, sh), jnp.asarray(p3d),
            jax.device_put(jp2d, sh), jax.device_put(jw, sh), jnp.asarray(LO),
            jnp.asarray(HI), jnp.ones(6), jax.device_put(jfv, sh))
        (p2d_p, w_p, poses_p, fv_p), _ = TPA._pad([p2d, w, poses0, fv])
        got = mesh.make_ba_solver(project_eucm, mesh.make_mesh())(
            t(gt * 1.03), poses_p, t(p3d), p2d_p, w_p, t(LO), t(HI),
            torch.ones(6, dtype=F64), fv_p)
    assert got.n_iters == int(want[3])
    assert loops and all(s["graphed"] for s in loops)


def test_graphed_pose_init_matches_jax(graphed):
    """``pose_init`` (one graph per model and shape on the card) against
    ``_pose_init_device``: frame masks equal, poses within ``POSE_ATOL``."""
    jb, jbatch, board, batch, _ = calib_case()
    params = seed_model().params
    want_p, want_v = JS._pose_init_device(
        jax_unproject_fn("eucm"), jnp.asarray(params), jnp.asarray(jbatch.p2d),
        jnp.asarray(jbatch.mask), jnp.asarray(jb.p3d, dtype=jnp.float64))
    got_p, got_v = single.pose_init(unproject_fn("eucm"), t(params), t(batch.p2d),
                                    torch.as_tensor(batch.mask), t(board.p3d))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=POSE_ATOL)


def rms(theta, poses, fv, board, batch):
    """Reprojection RMS (px) of a single-camera EUCM solution over the
    valid frames' observed corners."""
    from ccrs_tpu_torch.calib.validate import reprojection_errors
    from ccrs_tpu_torch.types import RvecTvec

    model = GenericModel("eucm", np.asarray(theta), 512, 512)
    po = np.asarray(poses)
    rt = {int(f): RvecTvec(po[f, :3], po[f, 3:]) for f in np.flatnonzero(np.asarray(fv) > 0)}
    errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, model, rt)])
    return float(np.sqrt(np.mean(errs**2)))


@pytest.mark.parametrize("variant", ["cold", "warm", "skip_pose_init"])
def test_graphed_calib_camera_solve_matches_jax(variant, graphed):
    """``calib_camera_solve`` through the graphed path (its prologue graph,
    then the LM's start and chunks) against ``_calib_camera_device`` (the
    JAX graph solves mixed, so the port takes ``solver="mixed"``): frame
    masks equal, RMS within ``RMS_TOL`` and theta within ``FLAT_RTOL``."""
    jb, jbatch, board, batch, poses = calib_case()
    model = seed_model()
    F = batch.n_frames
    lo, hi = single.build_bounds(model, False)
    warm_p, warm_v = np.zeros((F, 6)), np.zeros(F)
    if variant != "cold":
        warm_p, warm_v = poses + 1e-3, np.ones(F)
        if variant == "warm":
            warm_v[::3] = 0.0
    skip = variant == "skip_pose_init"
    want, want_fv = JS._calib_camera_device(
        jax_unproject_fn("eucm"), jax_project_fn("eucm"), jnp.asarray(model.params),
        jnp.asarray(model.params), jnp.asarray(jbatch.p2d), jnp.asarray(jbatch.mask),
        jnp.asarray(jb.p3d, dtype=jnp.float64), jnp.asarray(lo), jnp.asarray(hi),
        jnp.ones(6), jnp.asarray(warm_p), jnp.asarray(warm_v), one_focal=False,
        skip_pose_init=skip)
    warm = {} if variant == "cold" else dict(warm_poses=t(warm_p), warm_valid=t(warm_v))
    got, got_fv = single.calib_camera_solve(
        unproject_fn("eucm"), project_fn("eucm"), t(model.params), t(model.params),
        t(batch.p2d), torch.as_tensor(batch.mask), t(board.p3d), t(lo), t(hi),
        torch.ones(6, dtype=F64), one_focal=False, skip_pose_init=skip, solver="mixed",
        **warm)
    np.testing.assert_array_equal(got_fv.numpy(), np.asarray(want_fv))
    r_got = rms(got.theta.numpy(), got.poses.numpy(), got_fv.numpy(), board, batch)
    r_want = rms(np.asarray(want.theta), np.asarray(want.poses), np.asarray(want_fv), board,
                 batch)
    assert abs(r_got - r_want) < RMS_TOL, (r_got, r_want)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), rtol=FLAT_RTOL)


@pytest.mark.parametrize("fixed_focal", [None, 195.0])
def test_graphed_init_ucm_matches_jax(fixed_focal, graphed):
    """``init_ucm`` through the graphed path, on the subsets the JAX
    package draws from the same key, against ``_try_init_device`` (its
    stage 2 solves mixed, so the port's does too): ``ok`` equal and the UCM
    parameters within ``INIT_RTOL``."""
    jb, jbatch, board, batch, _ = calib_case()
    f0, f1 = initialize.find_best_two_frames(batch)
    q0, half = initialize._normalize(batch.p2d[f0], 512, 512)
    q1, _ = initialize._normalize(batch.p2d[f1], 512, 512)
    pair = batch.mask[f0] & batch.mask[f1]
    key = jax.random.PRNGKey(4)
    want, want_ok = JI._try_init_device(
        key, jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(pair),
        jnp.asarray(jb.p3d, dtype=jnp.float64), jnp.asarray(jbatch.p2d[[f0, f1]]),
        jnp.asarray(jbatch.mask[[f0, f1]]), jnp.float64(half),
        jnp.asarray([512.0, 512.0]), fixed_focal=fixed_focal)
    idx = torch.as_tensor(np.array(jax_draws(key, jnp.asarray(pair), initialize.N_SAMPLES)))
    got, ok = initialize.init_ucm(
        t(q0), t(q1), torch.as_tensor(pair), t(board.p3d), t(batch.p2d[[f0, f1]]),
        torch.as_tensor(batch.mask[[f0, f1]]), float(half), t([512.0, 512.0]),
        fixed_focal=fixed_focal, idx=idx, solver="mixed")
    assert bool(ok) == bool(want_ok) and bool(ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=INIT_RTOL)


def test_init_draws_from_the_generator_before_the_graph():
    """The RANSAC subsets come from the caller's generator outside the
    graph: an attempt equals the one handed the same generator's draws as
    ``idx``, and advances the generator as ``sample_subsets`` does."""
    from ccrs_tpu_torch.solve.homography import sample_subsets

    _, _, board, batch, _ = calib_case()
    f0, f1 = initialize.find_best_two_frames(batch)
    q0, half = initialize._normalize(batch.p2d[f0], 512, 512)
    q1, _ = initialize._normalize(batch.p2d[f1], 512, 512)
    pair = torch.as_tensor(batch.mask[f0] & batch.mask[f1])
    args = (t(q0), t(q1), pair, t(board.p3d), t(batch.p2d[[f0, f1]]),
            torch.as_tensor(batch.mask[[f0, f1]]), float(half), t([512.0, 512.0]))
    gen = torch.Generator().manual_seed(9)
    got = initialize.init_ucm(*args, generator=gen)
    after = torch.rand(3, generator=gen)
    ref_gen = torch.Generator().manual_seed(9)
    idx = sample_subsets(pair, initialize.N_SAMPLES, ref_gen)
    want = initialize.init_ucm(*args, idx=idx)
    assert torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
    assert torch.equal(after, torch.rand(3, generator=ref_gen))


# --------------------------------------------------------------------------
# threads
# --------------------------------------------------------------------------


def test_warmup_thread_never_reaches_a_capture(monkeypatch):
    """``prewarm_calibration`` on a thread of its own with graphs on: every
    graph it asks for is an eager stand-in (its ``no_capture`` scope),
    while this thread's solves meanwhile take the graphed path."""
    monkeypatch.setattr(graphs, "active", lambda where: not graphs._off())
    calls = {"warm": [], "main": []}
    real_get = graphs.get

    def get(*a, **k):
        name = "warm" if threading.current_thread().name == "warm" else "main"
        calls[name].append(graphs._off())
        return real_get(*a, **k)

    monkeypatch.setattr(graphs, "get", get)
    errors = []

    def warm():
        try:
            prewarm_calibration(create_default_6x6_board(), 4, "eucm", speculative=True,
                                device="cpu")
        except Exception as e:  # reported below
            errors.append(e)

    th = threading.Thread(target=warm, name="warm")
    th.start()
    while th.is_alive():
        _ba(noisy(), rtol=1e-6)
    th.join(timeout=300)
    assert not th.is_alive() and not errors
    assert calls["warm"] and all(calls["warm"])
    assert calls["main"] and not any(calls["main"])


def test_leases_give_threads_their_own_slots():
    """Two threads inside a lease of one name hold different slots; a
    slot comes free when its holder leaves."""
    inside, go = threading.Barrier(3), threading.Event()
    slots = []

    def hold():
        with graphs.lease("test") as slot:
            slots.append(slot)
            inside.wait(timeout=30)
            go.wait(timeout=30)

    threads = [threading.Thread(target=hold) for _ in range(2)]
    for th in threads:
        th.start()
    inside.wait(timeout=30)
    go.set()
    for th in threads:
        th.join(timeout=30)
    assert sorted(slots) == [0, 1]
    with graphs.lease("test") as slot:
        assert slot == 0


def test_no_capture_is_per_thread_and_nests():
    card = torch.device("cuda")
    assert graphs.active(card)
    seen = []
    with graphs.no_capture():
        assert not graphs.active(card)
        with graphs.no_capture():
            assert not graphs.active(card)
        assert not graphs.active(card)
        th = threading.Thread(target=lambda: seen.append(graphs.active(card)))
        th.start()
        th.join(timeout=30)
    assert seen == [True] and graphs.active(card)


def _held(n_shapes):
    """``n_shapes`` pairs of captured-looking graphs (an LM's start and
    chunk), each entered into the graph cache under a key of its own."""
    pairs = []
    for i in range(n_shapes):
        pair = []
        for part in ("start", "chunk"):
            g = graphs.Graph(None, (), (), (torch.zeros(i + 1),))
            g.graph = object()  # what a capture sets: ``keep`` holds only such graphs
            graphs._cache[(part, i)] = g
            pair.append(g)
        pairs.append(tuple(pair))
    return pairs


def test_keep_holds_the_shapes_used_last(monkeypatch):
    """``keep`` holds the graphs of the ``SHAPES_KEPT`` shapes a group's
    slot used last and drops the least recently used shape's graphs (both
    of its pair) from the cache; using a shape again makes it the newest;
    groups, slots and eager stand-ins do not count against each other."""
    for name in ("_cache", "_recent"):
        monkeypatch.setattr(graphs, name, {})
    monkeypatch.setattr(graphs, "_buffers", set())
    n = graphs.SHAPES_KEPT
    pairs = _held(n + 2)
    for pair in pairs[:n]:
        graphs.keep("ba", 0, pair)
    graphs.keep("ba", 0, pairs[0])  # shape 0 used again: shape 1 is now the oldest
    graphs.keep("ba", 1, pairs[1])  # another slot holds its own shapes
    graphs.keep("lm", 0, pairs[1])  # and so does another group
    graphs.keep("ba", 0, (graphs.Graph(None, (), (), (torch.zeros(1),)),))  # a stand-in
    assert len(graphs._cache) == 2 * (n + 2)
    graphs.keep("ba", 0, pairs[n])
    graphs.keep("ba", 0, pairs[n + 1])
    cached = set(map(id, graphs._cache.values()))
    for i, pair in enumerate(pairs):
        assert all((id(g) in cached) == (i not in (1, 2)) for g in pair), i
    assert len(graphs._recent[("ba", 0, torch.device("cpu"))]) == n
