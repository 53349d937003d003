"""The port's multi-device layer against the JAX package's, on the CPU.

The JAX side runs on its mesh of eight virtual CPU devices
(``tests/conftest.py``); the port's counterpart runs on eight CPU shards
(``default_mesh``), with the same numpy inputs.  Tolerances are
``tests/test_parallel.py``'s: one sharded step against ``ba_step_sharded``
rtol 1e-9 (poses atol 1e-9); 25 steps to the ground truth rtol 1e-8; the
full sharded solve against ``make_ba_solver`` rtol 1e-9 (poses 1e-8); the
sharded joint BA against ``make_multi_ba_solver`` theta rtol 1e-8,
extrinsics and poses 1e-8 / 1e-7; ``multi_ba_sharded`` against
``multi_ba_sharded_mixed`` with F = 18 on 8 shards (the padding path) rtol
1e-7, and 1e-6 against the ground truth.  Sharded detection equals the
unsharded detection bit for bit, tracked and cold.  The port's sharded
solvers also equal its own unsharded ``ba_solve`` / ``ba_solve_multi``
within 1e-10, and the joint BA's route takes the sharded solver on a
multi-device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.models.projections import project_eucm as jax_project_eucm
from ccrs_tpu.parallel import mesh as jax_mesh
from ccrs_tpu_torch.models.projections import project_eucm
from ccrs_tpu_torch.parallel import mesh
from ccrs_tpu_torch.solve.lm import ba_solve, ba_solve_multi

from test_parallel import _case

torch.set_num_threads(2)

F64 = torch.float64
CPU8 = [torch.device("cpu")] * 8
LO = [0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6]
HI = [1e4, 1e4, 512.0, 512.0, 1.0, 10.0]


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64)


@pytest.fixture
def cpu8():
    with mesh.default_mesh(CPU8) as m:
        yield m


def test_mesh_is_the_default_list_and_raises_beyond_it(cpu8):
    assert len(jax.devices()) == 8
    assert mesh.make_mesh() == CPU8
    assert mesh.make_mesh(3) == CPU8[:3]
    with pytest.raises(ValueError, match="only 8 device"):
        mesh.make_mesh(9)
    with mesh.default_mesh(["cpu", "cpu"]):
        assert len(mesh.make_mesh()) == 2
    assert mesh.make_mesh() == CPU8  # restored on exit


def test_mesh_without_a_default_is_the_visible_cards():
    """No CPU fallback: without a default list the mesh is the CUDA
    devices, and asking for more than are visible raises."""
    n = torch.cuda.device_count()
    assert mesh.make_mesh() == [torch.device("cuda", i) for i in range(n)]
    with pytest.raises(ValueError):
        mesh.make_mesh(n + 1)
    with pytest.raises(ValueError, match="empty mesh"):
        mesh.make_ba_solver(project_eucm, [])


def _pad(arrs):
    (out, F) = mesh.pad_frames([t(a) for a in arrs], 8)
    return out, F


def test_sharded_step_matches_jax(cpu8):
    gt, p3d, poses_gt, p2d = _case()
    theta0, poses0 = gt * 1.02, poses_gt + 0.002
    w = np.ones(p2d.shape[:2])
    (jp2d, jw, jposes), F = jax_mesh.pad_frames(
        [jnp.asarray(p2d), jnp.asarray(w), jnp.asarray(poses0)], 8
    )
    want_th, want_po = jax_mesh.ba_step_sharded(
        jax_project_eucm, jnp.asarray(theta0), jposes, jnp.asarray(p3d), jp2d, jw,
        jnp.ones(6), jnp.asarray(1e-6), jax_mesh.make_mesh(),
    )
    (p2d_p, w_p, poses_p), F = _pad([p2d, w, poses0])
    th, po = mesh.ba_step_sharded(
        project_eucm, t(theta0), poses_p, t(p3d), p2d_p, w_p, torch.ones(6, dtype=F64),
        1e-6, mesh.make_mesh(),
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(want_th), rtol=1e-9)
    np.testing.assert_allclose(po.numpy()[:F], np.asarray(want_po)[:F], rtol=0, atol=1e-9)


def test_sharded_iterations_converge(cpu8):
    gt, p3d, poses_gt, p2d = _case(F=24, seed=1)
    (p2d_p, w_p, poses), F = _pad([p2d, np.ones(p2d.shape[:2]), poses_gt + 0.003])
    theta, free, p3d_t = t(gt * 1.03), torch.ones(6, dtype=F64), t(p3d)
    step = mesh.make_ba_step(project_eucm, mesh.make_mesh())
    for _ in range(25):
        theta, poses = step(theta, poses, p3d_t, p2d_p, w_p, free, 1e-8)
    np.testing.assert_allclose(theta.numpy(), gt, rtol=1e-8)


def _multi_case(F, seed, ext1, scale1, th_scale, ext_off):
    """The stereo problem of tests/test_parallel.py (cam1 behind ``ext1``)."""
    from ccrs_tpu.solve import se3 as jse3

    gt, p3d, poses_gt, p2d0 = _case(F=F, seed=seed)
    C, N = 2, p2d0.shape[1]
    ext_gt = np.array([[0.0] * 6, ext1])
    gt1 = gt * np.asarray(scale1)
    p2d = np.zeros((C, F, N, 2))
    p2d[0] = p2d0
    for f in range(F):
        rv, tv = jse3.compose(
            jnp.asarray(ext_gt[1, :3]), jnp.asarray(ext_gt[1, 3:]),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        pc = p3d @ np.asarray(jse3.exp_so3(rv)).T + np.asarray(tv)
        p2d[1, f] = np.asarray(jax_project_eucm(jnp.asarray(gt1), jnp.asarray(pc))[0])
    args = dict(
        theta0=np.stack([gt * th_scale[0], gt1 * th_scale[1]]),
        ext0=ext_gt + np.array([[0.0] * 6, [ext_off] * 6]),
        poses0=poses_gt + (0.003 if F == 16 else 0.002),
        p3d=p3d, p2d=p2d, w=np.ones((C, F, N)),
        lo=np.tile(LO, (C, 1)), hi=np.tile(HI, (C, 1)), free=np.ones((C, 6)),
        cam_frame_valid=np.ones((C, F)), frame_valid=np.ones(F),
    )
    return args, gt, gt1, ext_gt


def test_sharded_multicam_solve_matches_jax(cpu8):
    args, gt, gt1, ext_gt = _multi_case(
        16, 3, [0.02, -0.015, 0.005, -0.11, 0.002, 0.004],
        [1.01, 1.005, 0.998, 1.002, 0.97, 1.02], (1.02, 0.98), 2e-3,
    )
    jsolve = jax_mesh.make_multi_ba_solver(jax_project_eucm, jax_mesh.make_mesh())
    sh = jax_mesh.sharded_frame_sharding(jax_mesh.make_mesh())
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    jargs["poses0"] = jax.device_put(jargs["poses0"], sh)
    jargs["frame_valid"] = jax.device_put(jargs["frame_valid"], sh)
    jth, jex, jpo, _, _ = jsolve(*jargs.values())
    res = mesh.make_multi_ba_solver(project_eucm, mesh.make_mesh())(
        *(t(v) for v in args.values())
    )
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jth), rtol=1e-8)
    np.testing.assert_allclose(res.ext.numpy(), np.asarray(jex), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.poses.numpy(), np.asarray(jpo), rtol=0, atol=1e-7)
    # and the ground truth of this noiseless problem
    np.testing.assert_allclose(res.theta[0].numpy(), gt, rtol=1e-7)
    np.testing.assert_allclose(res.theta[1].numpy(), gt1, rtol=1e-7)
    np.testing.assert_allclose(res.ext[1].numpy(), ext_gt[1], rtol=0, atol=1e-7)


def test_full_sharded_solve_matches_jax(cpu8):
    gt, p3d, poses_gt, p2d = _case(F=24, seed=2)
    poses0, w, fv = poses_gt + 0.004, np.ones(p2d.shape[:2]), np.ones(p2d.shape[0])
    jm = jax_mesh.make_mesh()
    sh = jax_mesh.sharded_frame_sharding(jm)
    (jp2d, jw, jposes, jfv), F = jax_mesh.pad_frames(
        [jnp.asarray(p2d), jnp.asarray(w), jnp.asarray(poses0), jnp.asarray(fv)], 8
    )
    jth, jpo, _, _ = jax_mesh.make_ba_solver(jax_project_eucm, jm)(
        jnp.asarray(gt * 1.03), jax.device_put(jposes, sh), jnp.asarray(p3d),
        jax.device_put(jp2d, sh), jax.device_put(jw, sh), jnp.asarray(LO),
        jnp.asarray(HI), jnp.ones(6), jax.device_put(jfv, sh),
    )
    (p2d_p, w_p, poses_p, fv_p), F = _pad([p2d, w, poses0, fv])
    res = mesh.make_ba_solver(project_eucm, mesh.make_mesh())(
        t(gt * 1.03), poses_p, t(p3d), p2d_p, w_p, t(LO), t(HI),
        torch.ones(6, dtype=F64), fv_p,
    )
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jth), rtol=1e-9)
    np.testing.assert_allclose(res.poses.numpy()[:F], np.asarray(jpo)[:F], rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.theta.numpy(), gt, rtol=1e-8)


def test_multi_ba_sharded_matches_jax_mixed(cpu8):
    """multi_ba_sharded (the joint BA's multi-device route) against the JAX
    package's multi_ba_sharded_mixed, F = 18 on 8 shards: the padding path."""
    args, gt, gt1, _ = _multi_case(
        18, 5, [0.01, -0.02, 0.004, -0.1, 0.003, 0.001],
        [1.012, 1.003, 0.999, 1.001, 0.98, 1.01], (1.02, 0.985), 1e-3,
    )
    want = jax_mesh.multi_ba_sharded_mixed(
        jax_project_eucm, *(jnp.asarray(v) for v in args.values())
    )
    res = mesh.multi_ba_sharded(project_eucm, *(t(v) for v in args.values()))
    assert res.poses.shape == (18, 6)
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(want.theta), rtol=1e-7)
    np.testing.assert_allclose(res.ext.numpy(), np.asarray(want.ext), rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.theta[0].numpy(), gt, rtol=1e-6)
    np.testing.assert_allclose(res.theta[1].numpy(), gt1, rtol=1e-6)


def test_sharded_solvers_match_unsharded_port(cpu8):
    """The port's sharded solvers against its own single-device solvers on
    the same problem, within 1e-10 (the reduction order is the only
    difference on this noiseless problem)."""
    gt, p3d, poses_gt, p2d = _case(F=24, seed=2)
    poses0, w, fv = poses_gt + 0.004, np.ones(p2d.shape[:2]), np.ones(p2d.shape[0])
    ref = ba_solve(project_eucm, t(gt * 1.03), t(poses0), t(p3d), t(p2d), t(w),
                   t(LO), t(HI), torch.ones(6, dtype=F64), t(fv))
    (p2d_p, w_p, poses_p, fv_p), F = _pad([p2d, w, poses0, fv])
    res = mesh.make_ba_solver(project_eucm, mesh.make_mesh())(
        t(gt * 1.03), poses_p, t(p3d), p2d_p, w_p, t(LO), t(HI),
        torch.ones(6, dtype=F64), fv_p,
    )
    np.testing.assert_allclose(res.theta.numpy(), ref.theta.numpy(), rtol=1e-10)
    np.testing.assert_allclose(res.poses.numpy()[:F], ref.poses.numpy(), rtol=0, atol=1e-10)

    args, _, _, _ = _multi_case(
        18, 5, [0.01, -0.02, 0.004, -0.1, 0.003, 0.001],
        [1.012, 1.003, 0.999, 1.001, 0.98, 1.01], (1.02, 0.985), 1e-3,
    )
    targs = [t(v) for v in args.values()]
    ref = ba_solve_multi(project_eucm, *targs)
    res = mesh.multi_ba_sharded(project_eucm, *targs)
    np.testing.assert_allclose(res.theta.numpy(), ref.theta.numpy(), rtol=1e-10)
    np.testing.assert_allclose(res.ext.numpy(), ref.ext.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.poses.numpy(), ref.poses.numpy(), rtol=0, atol=1e-10)


def test_joint_ba_routes_through_the_mesh(cpu8, monkeypatch):
    """calib_all_camera_with_extrinsics shards on a multi-device mesh of
    the requested device type (F >= mesh size), as ccrs_tpu's does over
    jax.devices(), and lands on the single-device result."""
    from ccrs_tpu_torch.calib import multi
    from test_torch_multicam import _port_inputs, _rig

    board, cams, batches, rts = _port_inputs(*_rig(2, F=10, seed=5))
    kw = dict(xy_same_focal=False, disabled_distortions=0, cam0_fixed_focal=False,
              device="cpu")
    init = multi.init_camera_extrinsic(rts, device="cpu")
    calls = []
    real = multi.multi_ba_sharded
    monkeypatch.setattr(multi, "multi_ba_sharded",
                        lambda *a, **k: calls.append(k["mesh"]) or real(*a, **k))
    sharded = multi.calib_all_camera_with_extrinsics(board, cams, init, rts, batches, **kw)
    assert calls == [CPU8]
    with mesh.default_mesh(["cpu"]):
        single = multi.calib_all_camera_with_extrinsics(board, cams, init, rts, batches, **kw)
    with mesh.default_mesh([torch.device("meta")] * 2):  # another device type
        other = multi.calib_all_camera_with_extrinsics(board, cams, init, rts, batches, **kw)
    assert len(calls) == 1  # neither a one-device nor a foreign mesh shards
    for got in (sharded, other):
        for a, b in zip(got[0], single[0]):
            np.testing.assert_allclose(a.params, b.params, rtol=1e-10)
        for f in single[2]:
            np.testing.assert_allclose(got[2][f].tvec, single[2][f].tvec, rtol=0, atol=1e-10)


# --------------------------------------------------------------------------
# sharded detection
# --------------------------------------------------------------------------


def _frames(n=16):
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import get_family
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

    board = create_default_6x6_board()
    model = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
    poses = smooth_sequence_poses(n, board, seed=5)
    gen = torch.Generator().manual_seed(5)
    return board, render_frames_device(model, board, get_family("t36h11"), poses,
                                       noise=1.0, generator=gen, device="cpu")


@pytest.mark.parametrize("track", [False, True])
def test_sharded_detect_matches_single_device(cpu8, track):
    """Detection has no cross-frame reduction: sharding changes placement
    only, so the sharded detections equal the unsharded ones exactly."""
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.parallel.mesh import FrameShards

    board, frames = _frames()
    base_det = TagDetector("t36h11", track=track, shard=False, device="cpu")
    base = base_det.detect_batch(None, board, dev_images=frames)
    sh_det = TagDetector("t36h11", track=track, shard=True, device="cpu")
    seen = []
    real = sh_det._detect_batch_cold
    sh_det._detect_batch_cold = lambda d, *a, **k: seen.append(d) or real(d, *a, **k)
    sh = sh_det.detect_batch(None, board, dev_images=frames)
    assert isinstance(seen[0], FrameShards) and len(seen[0].parts) == 8
    assert len(base) == len(sh) == 16
    for f, (a, b) in enumerate(zip(base, sh)):
        assert sorted(a) == sorted(b), f"track={track} frame {f}"
        for tid in a:
            np.testing.assert_array_equal(a[tid], b[tid], err_msg=f"frame {f} tag {tid}")
    assert sh_det.stats == base_det.stats


def test_shard_switch_and_batch_rules(cpu8, monkeypatch):
    """shard=None reads CCRS_SHARD_DETECT and otherwise shards only on a
    mesh of several CUDA devices; a batch that does not divide the mesh, or
    lies on another device type, stays whole."""
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.parallel.mesh import FrameShards

    x16, x12 = torch.zeros((16, 8, 8)), torch.zeros((12, 8, 8))
    monkeypatch.delenv("CCRS_SHARD_DETECT", raising=False)
    assert TagDetector(device="cpu").shard is None
    assert TagDetector(device="cpu")._shard_frames(x16) is x16  # a CPU mesh: auto is off
    monkeypatch.setenv("CCRS_SHARD_DETECT", "1")
    det = TagDetector(device="cpu")
    assert det.shard is True and isinstance(det._shard_frames(x16), FrameShards)
    assert det._shard_frames(x12) is x12
    monkeypatch.setenv("CCRS_SHARD_DETECT", "0")
    assert TagDetector(device="cpu")._shard_frames(x16) is x16
    with mesh.default_mesh([torch.device("meta")] * 8):
        assert TagDetector(shard=True, device="cpu")._shard_frames(x16) is x16


def test_frame_shards_gather_in_order(cpu8):
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 2, 2)
    sh = mesh.shard_frames(x, mesh.make_mesh())
    assert sh.shape == x.shape and len(sh.parts) == 8
    idx = np.array([15, 0, 7, 8, 3])
    assert torch.equal(sh.index_select(0, idx), x[idx])
    assert torch.equal(sh.index_select(0, torch.as_tensor(idx)), x[idx])
    with pytest.raises(ValueError):
        mesh.shard_frames(x[:12], mesh.make_mesh(5))
