"""Multi-camera calibration of the PyTorch port against the JAX package.

Feature-level stereo (and mono) rigs from ``tests/synthetic.py`` with
0.1 px observation noise go through both packages' ``init_camera_extrinsic``
and ``calib_all_camera_with_extrinsics`` from the same perturbed per-camera
results, carried into the port with ``interop``.  Both reach the same
float64 optimum, though ``ccrs_tpu`` descends in float32 first: RMS within
1e-6 px, intrinsics within 1e-5 relative, extrinsics and board poses within
1e-6 abs.
"""

import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.calib.frames import FrameBatch as JaxFrameBatch
from ccrs_tpu.calib.multi import (
    calib_all_camera_with_extrinsics as jax_calib_all,
    init_camera_extrinsic as jax_init_ext,
)
from ccrs_tpu.calib.validate import reprojection_errors as jax_reproj
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.types import RvecTvec as JaxRvecTvec
from ccrs_tpu_torch.calib.multi import (
    calib_all_camera_with_extrinsics,
    init_camera_extrinsic,
)
from ccrs_tpu_torch.calib.validate import reprojection_errors
from ccrs_tpu_torch.interop import (
    board_from_ref,
    frame_batch_from_ref,
    model_from_ref,
    rvectvec_from_ref,
)
from ccrs_tpu_torch.solve import se3

from synthetic import make_synthetic_batch, tumvi_like_eucm

torch.set_num_threads(2)

R10 = np.array([0.02, -0.015, 0.005])
T10 = np.array([-0.11, 0.002, 0.004])
F64 = torch.float64


def _compose(r_a, t_a, r_b, t_b):
    rv, tv = se3.compose(*(torch.as_tensor(v, dtype=F64) for v in (r_a, t_a, r_b, t_b)))
    return rv.numpy(), tv.numpy()


def _rig(n_cams, F=14, seed=2):
    """Observations of ``n_cams`` cameras (cam1 behind a small baseline),
    perturbed per-camera results as the joint solve's input, and the JAX
    package's objects."""
    board = jax_board()
    cams = [tumvi_like_eucm(),
            JaxModel("eucm", [192.0, 191.5, 255.5, 254.5, 0.61, 1.05], 512, 512)]
    batch0, poses_gt = make_synthetic_batch(cams[0], board, n_frames=F, seed=seed)
    rng = np.random.default_rng(seed + 1)
    batches = [batch0]
    if n_cams > 1:
        p2d1 = np.zeros_like(batch0.p2d)
        mask1 = np.zeros_like(batch0.mask)
        for f in range(F):
            rv, tv = _compose(R10, T10, poses_gt[f, :3], poses_gt[f, 3:])
            pc = JaxRvecTvec(rv, tv).transform(board.p3d)
            p2d, valid = model_from_ref(cams[1]).project(pc)
            inside = valid & (p2d >= 0).all(1) & (p2d < 512).all(1)
            p2d1[f] = np.where(inside[:, None], p2d, 0.0)
            mask1[f] = inside
        batches.append(JaxFrameBatch(batch0.time_ns.copy(), p2d1, mask1, 512, 512))
    for b in batches:
        b.p2d = b.p2d + rng.normal(size=b.p2d.shape) * 0.1
    cams_in, rts = [], []
    for c in range(n_cams):
        m = cams[c].copy()
        m.set_params(cams[c].params * (1 + rng.normal(size=6) * 0.01))
        cams_in.append(m)
        rt = {}
        for f in range(F):
            rv, tv = poses_gt[f, :3], poses_gt[f, 3:]
            if c > 0:
                rv, tv = _compose(R10, T10, rv, tv)
            rt[f] = JaxRvecTvec(
                rv + rng.normal(size=3) * 2e-3, tv + rng.normal(size=3) * 2e-3
            )
        rts.append(rt)
    return board, cams_in, batches, rts


def _port_inputs(board, cams, batches, rts):
    return (
        board_from_ref(board),
        [model_from_ref(m) for m in cams],
        [frame_batch_from_ref(b) for b in batches],
        [{f: rvectvec_from_ref(rt) for f, rt in r.items()} for r in rts],
    )


def _rms(per_frame):
    errs = np.concatenate([e for _, e, _ in per_frame])
    return float(np.sqrt(np.mean(errs**2)))


def test_init_camera_extrinsic_matches_reference():
    board, cams, batches, rts = _rig(2)
    _, _, _, t_rts = _port_inputs(board, cams, batches, rts)
    want = jax_init_ext(rts)
    got = init_camera_extrinsic(t_rts, device="cpu")
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.rvec, w.rvec, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.tvec, w.tvec, rtol=0, atol=1e-6)
    # and the pose-graph init lands on the rig within the pose noise
    np.testing.assert_allclose(got[1].rvec, R10, atol=2e-3)
    np.testing.assert_allclose(got[1].tvec, T10, atol=2e-3)


@pytest.mark.parametrize("n_cams", [1, 2])
def test_joint_ba_matches_reference(n_cams):
    board, cams, batches, rts = _rig(n_cams)
    t_board, t_cams, t_batches, t_rts = _port_inputs(board, cams, batches, rts)
    t_init = init_camera_extrinsic(t_rts, device="cpu")
    j_init = [JaxRvecTvec(t.rvec, t.tvec) for t in t_init]
    kw = dict(xy_same_focal=False, disabled_distortions=0, cam0_fixed_focal=False)
    want = jax_calib_all(board, cams, j_init, rts, batches, **kw)
    got = calib_all_camera_with_extrinsics(t_board, t_cams, t_init, t_rts, t_batches, **kw, device="cpu")
    assert want is not None and got is not None
    (j_models, j_ext, j_poses), (t_models, t_ext, t_poses) = want, got
    assert sorted(t_poses) == sorted(j_poses)
    for c in range(n_cams):
        np.testing.assert_allclose(t_models[c].params, j_models[c].params, rtol=1e-5)
        np.testing.assert_allclose(t_ext[c].rvec, j_ext[c].rvec, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_ext[c].tvec, j_ext[c].tvec, rtol=0, atol=1e-6)
        j_rt = {f: j_ext[c].compose(p) for f, p in j_poses.items()}
        t_rt = {f: t_ext[c].compose(p) for f, p in t_poses.items()}
        rms_j = _rms(jax_reproj(board, batches[c], j_models[c], j_rt))
        rms_t = _rms(reprojection_errors(t_board, t_batches[c], t_models[c], t_rt))
        assert abs(rms_t - rms_j) < 1e-6, (c, rms_t, rms_j)
        assert rms_t < 0.2  # the 0.1 px noise floor, not a stuck solve
    for f in j_poses:
        np.testing.assert_allclose(t_poses[f].rvec, j_poses[f].rvec, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_poses[f].tvec, j_poses[f].tvec, rtol=0, atol=1e-6)
    if n_cams == 2:
        np.testing.assert_allclose(t_ext[1].rvec, R10, atol=2e-3)
        np.testing.assert_allclose(t_ext[1].tvec, T10, atol=2e-3)


def test_ba_solve_multi_pins_cam0_and_fixed_focal():
    """Row 0 of the extrinsics stays the identity, and cam0_fixed_focal
    holds cam0's fx at its input value."""
    board, cams, batches, rts = _rig(2, F=10, seed=5)
    t_board, t_cams, t_batches, t_rts = _port_inputs(board, cams, batches, rts)
    t_init = init_camera_extrinsic(t_rts, device="cpu")
    out = calib_all_camera_with_extrinsics(
        t_board, t_cams, t_init, t_rts, t_batches, xy_same_focal=False,
        disabled_distortions=0, cam0_fixed_focal=True,
        device="cpu",
    )
    models, ext, _ = out
    assert models[0].params[0] == t_cams[0].params[0]
    assert models[1].params[0] != t_cams[1].params[0]
    assert np.all(ext[0].rvec == 0) and np.all(ext[0].tvec == 0)
