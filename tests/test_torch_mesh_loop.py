"""The frame-sharded LM's per-shard route (``solve/lm.py::_shard_loop``) on
the CPU.

Over several cards each card replays its shard's phases of an LM iteration
as captured graphs, with the copies between cards queued between replays
and one host read per ``CHUNK_ITERS`` iterations.  Here the route runs on
meshes of CPU shards (``["cpu"] * 2`` and ``["cpu"] * 8``) inside
``lm.shard_graphs()``, where ``graphs.get`` hands out eager stand-ins that
run the same phase functions on the same buffers.
``tests/test_torch_cuda.py`` holds the captured graphs on the card.

- The per-shard route against the routes the same mesh takes without it:
  the eager route (one host read per iteration) and the fused route
  (``graphs.active`` patched to take the CPU: one chunk of ``CHUNK_ITERS``
  iterations per read): ``theta``, ``ext``, poses, ``cost`` and
  ``n_iters`` equal bit for bit (``BITS``), for ``make_ba_solver`` (mesh
  rules) and ``ba_lm`` without them, ``make_multi_ba_solver``,
  ``multi_ba_sharded`` with F = 23 (the padding path) and
  ``multi_ba_sharded_mixed``, and for the joint BA's route through
  ``calib_all_camera_with_extrinsics``.
- The same solves against the JAX package's ``make_ba_solver``,
  ``make_multi_ba_solver`` and ``multi_ba_sharded_mixed`` on its eight
  virtual CPU devices, at ``tests/test_torch_parallel.py``'s tolerances
  (``JAX_*`` below) and with JAX's iteration counts.
- Chunks of K in {3, 8} against K = 1: a stop inside a chunk leaves every
  shard's state as a run of exactly ``n_iters`` iterations leaves it, bit
  for bit; the masked iterations are the chunks' rest.
- ``loop_counts()``: one host read (chunk) per ``CHUNK_ITERS`` iterations,
  the solves counted under the route that ran them; ``_route``'s choice
  on every kind of mesh.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mixed as TMX
import test_torch_parallel as TPA
from ccrs_tpu.models.projections import project_eucm as jax_project_eucm
from ccrs_tpu.parallel import mesh as jax_mesh
from ccrs_tpu_torch import graphs
from ccrs_tpu_torch.models.projections import project_eucm
from ccrs_tpu_torch.parallel import mesh
from ccrs_tpu_torch.solve import lm

torch.set_num_threads(2)

F64 = torch.float64
CPU = torch.device("cpu")
#: the per-shard route against the other routes: every bit
BITS = 0.0
#: tests/test_torch_parallel.py's tolerances against the JAX mesh solvers
JAX_BA_THETA_RTOL, JAX_BA_POSES_ATOL = 1e-9, 1e-8
JAX_MULTI_THETA_RTOL, JAX_MULTI_EXT_ATOL, JAX_MULTI_POSES_ATOL = 1e-8, 1e-8, 1e-7
JAX_MIXED_THETA_RTOL, JAX_MIXED_EXT_ATOL = 1e-7, 1e-7

t = TPA.t


def _ba_problem():
    """``tests/test_torch_parallel.py``'s 24-frame single-camera problem."""
    gt, p3d, poses_gt, p2d = TPA._case(F=24, seed=2)
    return dict(theta0=gt * 1.03, poses0=poses_gt + 0.004, p3d=p3d, p2d=p2d,
                w=np.ones(p2d.shape[:2]), lo=TPA.LO, hi=TPA.HI, free=np.ones(6),
                frame_valid=np.ones(p2d.shape[0]))


def _stereo(F, seed=5):
    """``tests/test_torch_parallel.py``'s stereo problem with F frames."""
    args, *_ = TPA._multi_case(
        F, seed, [0.01, -0.02, 0.004, -0.1, 0.003, 0.001],
        [1.012, 1.003, 0.999, 1.001, 0.98, 1.01], (1.02, 0.985), 1e-3,
    )
    return args


def _ba(cpus, mesh_rules=True, **opts):
    a = _ba_problem()
    (poses0, p2d, w, fv), _ = mesh.pad_frames(
        [t(a["poses0"]), t(a["p2d"]), t(a["w"]), t(a["frame_valid"])], len(cpus))
    return lm.ba_lm(project_eucm, t(a["theta0"]), poses0, t(a["p3d"]), p2d, w, t(a["lo"]),
                    t(a["hi"]), t(a["free"]), fv, cpus, False, lm.LMOptions(**opts),
                    mesh_rules=mesh_rules)


def _make_ba_solver(cpus):
    a = _ba_problem()
    (poses0, p2d, w, fv), _ = mesh.pad_frames(
        [t(a["poses0"]), t(a["p2d"]), t(a["w"]), t(a["frame_valid"])], len(cpus))
    return mesh.make_ba_solver(project_eucm, cpus)(
        t(a["theta0"]), poses0, t(a["p3d"]), p2d, w, t(a["lo"]), t(a["hi"]), t(a["free"]), fv)


def _noisy_stereo():
    """``tests/test_torch_mixed.py``'s stereo problem with 0.1 px noise (F =
    16): its stop falls off the optimum's rounding noise, so the JAX
    package stops at the same iteration."""
    return TMX.stereo_case(0.1)[0]


def _make_multi_ba_solver(cpus, args=None):
    args = _stereo(16) if args is None else args
    return mesh.make_multi_ba_solver(project_eucm, cpus)(*(t(v) for v in args.values()))


def _multi_ba_sharded(cpus, F=23):
    return mesh.multi_ba_sharded(project_eucm, *(t(v) for v in _stereo(F).values()), mesh=cpus)


def _multi_ba_sharded_mixed(cpus, F=18):
    return mesh.multi_ba_sharded_mixed(project_eucm, *(t(v) for v in _stereo(F).values()),
                                       mesh=cpus)


#: name -> solve over a mesh of CPU shards
SOLVES = {
    "make_ba_solver": _make_ba_solver,
    "ba_lm without mesh rules": lambda cpus: _ba(cpus, mesh_rules=False),
    "make_multi_ba_solver": _make_multi_ba_solver,
    "multi_ba_sharded F=23": _multi_ba_sharded,
    "multi_ba_sharded_mixed": _multi_ba_sharded_mixed,
}


def bits(res):
    """Every number of a result: its tensors and its iteration counts."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in res]


def assert_same_bits(got, want):
    got, want = bits(got), bits(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=BITS, atol=BITS)
        assert g.tobytes() == w.tobytes()


@pytest.fixture
def fused(monkeypatch):
    """``graphs.active`` takes the CPU: a mesh on one device takes the
    fused route (its graphs are eager stand-ins here)."""
    def run(fn, cpus):
        with monkeypatch.context() as m:
            m.setattr(graphs, "active", lambda where: not graphs._off())
            return fn(cpus)
    return run


def solve_counted(fn, cpus, shards):
    """(result, loop counts) of ``fn(cpus)``, through the per-shard route
    when ``shards``."""
    lm.reset_loop_counts()
    with lm.shard_graphs(shards):
        res = fn(cpus)
    return res, lm.loop_counts()


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", list(SOLVES))
def test_per_shard_route_equals_the_other_routes(name, n, fused):
    """The per-shard route over n CPU shards against the eager and the
    fused route on the same mesh: every bit of every result, and the same
    iterations; each ran on the route it names, the per-shard route with
    one host read per chunk of ``CHUNK_ITERS`` iterations."""
    cpus = [CPU] * n
    fn = SOLVES[name]
    got, counts = solve_counted(fn, cpus, True)
    eager, eager_counts = solve_counted(fn, cpus, False)
    lm.reset_loop_counts()
    via_fused = fused(fn, cpus)
    fused_counts = lm.loop_counts()
    assert_same_bits(got, eager)
    assert_same_bits(got, via_fused)
    assert counts["iters"] == eager_counts["iters"] == fused_counts["iters"] > 0
    assert counts["routes"] == dict(fused=0, shards=counts["solves"], eager=0)
    assert eager_counts["routes"]["eager"] == fused_counts["routes"]["fused"] == counts["solves"]
    assert counts["chunks"] * lm.CHUNK_ITERS - counts["masked"] == counts["iters"]
    assert counts["masked"] < lm.CHUNK_ITERS * counts["solves"]  # in each solve's last chunk
    assert eager_counts["chunks"] == eager_counts["iters"]


def test_joint_ba_route_reaches_the_per_shard_route():
    """``calib_all_camera_with_extrinsics`` on a mesh of 8 CPU shards
    (the CLI's joint BA) takes the per-shard route inside the switch, and
    its models, extrinsics and board poses equal the eager route's bit
    for bit."""
    from ccrs_tpu_torch.calib import multi
    from test_torch_multicam import _port_inputs, _rig

    board, cams, batches, rts = _port_inputs(*_rig(2, F=10, seed=5))
    init = multi.init_camera_extrinsic(rts, device="cpu")
    kw = dict(xy_same_focal=False, disabled_distortions=0, cam0_fixed_focal=False,
              device="cpu")
    with mesh.default_mesh(TPA.CPU8):
        want = multi.calib_all_camera_with_extrinsics(board, cams, init, rts, batches, **kw)
        lm.reset_loop_counts()
        with lm.shard_graphs():
            got = multi.calib_all_camera_with_extrinsics(board, cams, init, rts, batches, **kw)
    assert lm.loop_counts()["routes"]["shards"] == 1
    for a, b in zip(got[0], want[0]):
        assert a.params.tobytes() == b.params.tobytes()
    for a, b in zip(got[1], want[1]):
        assert a.rvec.tobytes() == b.rvec.tobytes() and a.tvec.tobytes() == b.tvec.tobytes()
    assert sorted(got[2]) == sorted(want[2])
    for f in want[2]:
        assert got[2][f].rvec.tobytes() == want[2][f].rvec.tobytes()
        assert got[2][f].tvec.tobytes() == want[2][f].tvec.tobytes()


# --------------------------------------------------------------------------
# the JAX package's mesh solvers
# --------------------------------------------------------------------------


def _jax_sharded(args, frame_keys):
    """The numpy ``args`` as JAX arrays, the frame-axis ones placed with the
    JAX mesh's frame sharding."""
    sh = jax_mesh.sharded_frame_sharding(jax_mesh.make_mesh())
    return {k: jax.device_put(jnp.asarray(v), sh) if k in frame_keys else jnp.asarray(v)
            for k, v in args.items()}


def test_per_shard_make_ba_solver_matches_jax():
    """``make_ba_solver`` over 8 CPU shards through the per-shard route
    against the JAX package's ``make_ba_solver``: theta within
    ``JAX_BA_THETA_RTOL``, poses within ``JAX_BA_POSES_ATOL``, the same
    iteration count."""
    a = _ba_problem()
    jargs = _jax_sharded(a, ("poses0", "p2d", "w", "frame_valid"))
    jth, jpo, _, jit = jax_mesh.make_ba_solver(jax_project_eucm, jax_mesh.make_mesh())(
        *jargs.values())
    got, counts = solve_counted(_make_ba_solver, TPA.CPU8, True)
    assert counts["routes"]["shards"] == 1
    assert got.n_iters == int(jit)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(jth), rtol=JAX_BA_THETA_RTOL)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(jpo), rtol=0,
                               atol=JAX_BA_POSES_ATOL)


def test_per_shard_make_multi_ba_solver_matches_jax():
    """``make_multi_ba_solver`` over 8 CPU shards through the per-shard
    route against the JAX package's, on the noisy stereo problem: theta
    within ``JAX_MULTI_THETA_RTOL``, extrinsics and poses within
    ``JAX_MULTI_EXT_ATOL`` / ``JAX_MULTI_POSES_ATOL``, the same iteration
    count.  (On noise-free data the joint solve stops on a vanished
    gradient at the rounding floor, where the two packages' summation
    orders stop it at other iterations.)"""
    args = _noisy_stereo()
    jargs = _jax_sharded(args, ("poses0", "frame_valid"))
    jth, jex, jpo, _, jit = jax_mesh.make_multi_ba_solver(
        jax_project_eucm, jax_mesh.make_mesh())(*jargs.values())
    got, counts = solve_counted(lambda cpus: _make_multi_ba_solver(cpus, args), TPA.CPU8, True)
    assert counts["routes"]["shards"] == 1
    assert got.n_iters == int(jit)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(jth), rtol=JAX_MULTI_THETA_RTOL)
    np.testing.assert_allclose(got.ext.numpy(), np.asarray(jex), rtol=0,
                               atol=JAX_MULTI_EXT_ATOL)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(jpo), rtol=0,
                               atol=JAX_MULTI_POSES_ATOL)


def test_per_shard_multi_ba_sharded_mixed_matches_jax():
    """``multi_ba_sharded_mixed`` over 8 CPU shards (F = 16) through the
    per-shard route, both stages, against the JAX package's
    ``multi_ba_sharded_mixed``: theta within ``JAX_MIXED_THETA_RTOL``,
    extrinsics within ``JAX_MIXED_EXT_ATOL``, the same iteration count
    over both stages.  (The padding path's bits are held against the
    other routes above; with F = 18 the noise-free polish stops at the
    rounding floor, where the packages part.)"""
    args = _stereo(16)
    want = jax_mesh.multi_ba_sharded_mixed(jax_project_eucm,
                                           *(jnp.asarray(v) for v in args.values()))
    got, counts = solve_counted(lambda cpus: _multi_ba_sharded_mixed(cpus, 16), TPA.CPU8, True)
    assert counts["routes"]["shards"] == 2 and got.poses.shape == (16, 6)
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=JAX_MIXED_THETA_RTOL)
    np.testing.assert_allclose(got.ext.numpy(), np.asarray(want.ext), rtol=0,
                               atol=JAX_MIXED_EXT_ATOL)


# --------------------------------------------------------------------------
# chunks, stops and counts
# --------------------------------------------------------------------------


#: name -> (solve over a mesh, its iterations on 2 shards): stops that
#: fall inside a chunk of 8, and inside a chunk of 3 or at its end
STOPS = {
    "ba rtol": (lambda cpus: _ba(cpus), 9),
    "ba max_iters 7": (lambda cpus: _ba(cpus, rtol=0.0, max_iters=7), 7),
    "joint rtol": (lambda cpus: _make_multi_ba_solver(cpus, _noisy_stereo()), 6),
}


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("name", list(STOPS))
def test_stop_inside_a_chunk_leaves_every_shard_as_n_iters_do(name, k, monkeypatch):
    """Chunks of k iterations against chunks of 1 on the per-shard route
    over 2 CPU shards: the same ``n_iters``, and every shard's poses,
    the iterate and the cost bit for bit as a run of exactly ``n_iters``
    iterations leaves them; the chunks' rest runs masked; one host read
    per chunk."""
    fn, iters = STOPS[name]
    cpus = [CPU] * 2
    monkeypatch.setattr(lm, "CHUNK_ITERS", 1)
    want, one = solve_counted(fn, cpus, True)
    monkeypatch.setattr(lm, "CHUNK_ITERS", k)
    got, counts = solve_counted(fn, cpus, True)
    assert want.n_iters == got.n_iters == iters
    assert one["masked"] == 0 and one["chunks"] == iters
    assert counts["chunks"] == math.ceil(iters / k)
    assert counts["masked"] == counts["chunks"] * k - iters
    assert_same_bits(got, want)


def test_route_choice():
    """``_route``: a mesh on one device that takes graphs is fused; shards
    on several such devices take the per-shard route; anything else runs
    eagerly; ``shard_graphs()`` sends any mesh of two or more shards
    through the per-shard route, and nests."""
    one, two = [CPU, CPU], [CPU, torch.device("meta")]
    assert lm._route(one) == lm._route(two) == lm._route([CPU]) == "eager"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(graphs, "active", lambda where: not graphs._off())
        assert lm._route(one) == lm._route([CPU]) == "fused"
        assert lm._route(two) == "shards"
        with graphs.eager():
            assert lm._route(two) == "eager"
    with lm.shard_graphs():
        assert lm._route(one) == lm._route(two) == "shards"
        assert lm._route([CPU]) == "eager"
        with lm.shard_graphs(False):
            assert lm._route(one) == "eager"
        assert lm._route(one) == "shards"
    assert lm._route(one) == "eager"


def test_keep_holds_graphs_a_newer_shape_shares(monkeypatch):
    """``graphs.keep`` drops the least recently used shape's graphs beyond
    ``SHAPES_KEPT`` but for those a newer shape holds too: the first
    device's phases of the per-shard route serve every shape whose
    first-device buffers are the same."""
    for name in ("_cache", "_recent"):
        monkeypatch.setattr(graphs, name, {})
    monkeypatch.setattr(graphs, "_buffers", set())

    def captured(key):
        g = graphs.Graph(None, (), (), (torch.zeros(1),))
        g.graph = object()  # what a capture sets: ``keep`` holds only such graphs
        graphs._cache[key] = g
        return g

    n = graphs.SHAPES_KEPT
    shared = captured("first device")
    own = [captured(("shard", i)) for i in range(n + 2)]
    for g in own:
        graphs.keep("ba shards", 0, (g, shared))
    cached = set(map(id, graphs._cache.values()))
    assert id(shared) in cached
    assert [id(g) in cached for g in own] == [False, False] + [True] * n
