"""Speculative calibration and warm starts of the PyTorch port, on the CPU.

The cases of tests/test_speculative.py, at its tolerances: a warm-started
final solve (with and without its PnP init) lands on the cold optimum
within 1e-6; the lerp fill re-branches axis-angle vectors (and equals the
JAX package's fill); the subsampled speculation and the tracked +
speculative pipeline end to end give the cold pipeline's calibration
within rtol 1e-6 / atol 1e-5; a long unsolved gap keeps its PnP init.
Then what the port adds: a warm trial that fails the gate leaves the
ladder's draws and result exactly as without speculation; the speculation
draws from its own copy of the camera's generator; an error in the
speculation thread is kept in ``spec.error`` and the ladder runs cold; two
speculations and a ladder running at once on three threads give the
results they give one at a time.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import ccrs_tpu_torch.calib.pipeline as pipeline_mod
from ccrs_tpu.calib.pipeline import fill_poses_lerp as jax_fill_poses_lerp
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.calib.pipeline import (
    SpeculativeCalib,
    calibrate_camera_with_retries,
    fill_poses_lerp,
)
from ccrs_tpu_torch.calib.single import calib_camera
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.models import GenericModel, zeros_like_model
from ccrs_tpu_torch.solve import se3
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses
from ccrs_tpu_torch.types import CalibParams

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def _render(n):
    board = create_default_6x6_board()
    poses = smooth_sequence_poses(n, board, seed=3)
    imgs = render_frames_device(
        GenericModel("eucm", GT, 512, 512), board, get_family("t36h11"), poses,
        noise=1.0, generator=torch.Generator().manual_seed(3),
        device="cpu",
    )
    return board, imgs


@pytest.fixture(scope="module")
def seq12():
    board, imgs = _render(12)
    dets = TagDetector("t36h11", track=False, device="cpu").detect_batch(None, board, dev_images=imgs)
    batch = FrameBatch.from_detections(dets, list(range(12)), board, 512, 512)
    model0 = GenericModel("eucm", [210.0, 210.0, 256.0, 256.0, 0.6, 1.0], 512, 512)
    cold = calib_camera(board, batch, model0, xy_same_focal=False,
                        disabled_distortions=0, fixed_focal=False, device="cpu")
    assert cold is not None
    return board, batch, cold


@pytest.fixture(scope="module")
def seq24():
    return _render(24)


def _rot(rvec):
    return se3.exp_so3(torch.as_tensor(rvec, dtype=torch.float64)).numpy()


def test_warm_start_matches_cold_optimum(seq12):
    board, batch, (model_c, rt_c) = seq12
    F = batch.p2d.shape[0]
    poses, valid = np.zeros((F, 6)), np.zeros(F)
    for i, rt in rt_c.items():
        poses[i, :3], poses[i, 3:] = rt.rvec, rt.tvec
        poses[i] += 1e-4 * np.sin(np.arange(6) + i)  # near, not on
        valid[i] = 1.0
    model_w, rt_w = calib_camera(
        board, batch, model_c.copy(), xy_same_focal=False, disabled_distortions=0,
        fixed_focal=False, warm_poses=poses, warm_valid=valid,
        device="cpu",
    )
    np.testing.assert_allclose(model_w.params, model_c.params, atol=1e-6)
    for i in rt_c:
        np.testing.assert_allclose(rt_w[i].rvec, rt_c[i].rvec, atol=1e-6)


def test_skip_pose_init_matches_cold_optimum(seq12):
    board, batch, (model_c, rt_c) = seq12
    F = batch.p2d.shape[0]
    poses, valid = np.zeros((F, 6)), np.zeros(F)
    for i, rt in rt_c.items():
        poses[i, :3], poses[i, 3:] = rt.rvec, rt.tvec
        poses[i] += 1e-3 * np.cos(np.arange(6) * 2 + i)
        valid[i] = 1.0
    assert fill_poses_lerp(poses, valid)
    model_w, rt_w = calib_camera(
        board, batch, model_c.copy(), xy_same_focal=False, disabled_distortions=0,
        fixed_focal=False, warm_poses=poses, warm_valid=np.ones(F), skip_pose_init=True,
        device="cpu",
    )
    np.testing.assert_allclose(model_w.params, model_c.params, atol=1e-6)
    for i in rt_c:
        # the lerp may re-branch an rvec: compare rotations
        np.testing.assert_allclose(_rot(rt_w[i].rvec), _rot(rt_c[i].rvec), atol=1e-6)
        np.testing.assert_allclose(rt_w[i].tvec, rt_c[i].tvec, atol=1e-6)
    with pytest.raises(ValueError):
        calib_camera(board, batch, model_c, False, 0, False, skip_pose_init=True, device="cpu")


def test_fill_poses_lerp_rvec_double_cover():
    axis = np.array([0.3, -0.5, 0.8])
    axis /= np.linalg.norm(axis)
    F = 9
    angles = np.linspace(np.pi - 0.2, np.pi + 0.2, F)
    poses, valid = np.zeros((F, 6)), np.zeros(F)
    for k in (0, 4, 8):
        r = axis * angles[k]
        if k == 8:  # the equivalent negative representative
            r = r * (1.0 - 2.0 * np.pi / angles[k])
        poses[k, :3] = r
        poses[k, 3:] = [0.1 * k, -0.2 * k, 1.0]
        valid[k] = 1.0
    ref = poses.copy()
    assert jax_fill_poses_lerp(ref, valid.copy())
    assert fill_poses_lerp(poses, valid)
    np.testing.assert_array_equal(poses, ref)
    for f in range(F):
        want, got = _rot(axis * angles[f]), _rot(poses[f, :3])
        cosang = (np.trace(want.T @ got) - 1.0) / 2.0
        assert np.arccos(np.clip(cosang, -1, 1)) < 0.06, f
    np.testing.assert_allclose(poses[2, 3:], [0.2, -0.4, 1.0], atol=1e-12)
    assert not fill_poses_lerp(np.zeros((3, 6)), np.array([0.0, 1.0, 0.0]))


def _pipeline(board, imgs, speculate, gen_seed=7):
    """Tracked detection (+ the speculation hook) -> FrameBatch -> ladder."""
    times = list(range(len(imgs)))
    det = TagDetector("t36h11", device="cpu")
    gen = torch.Generator().manual_seed(gen_seed)
    spec = SpeculativeCalib(board, times, zeros_like_model("eucm"), CalibParams(), gen, 512, 512)
    if speculate:
        det.on_provisional = spec.on_provisional
    dets = det.detect_batch(None, board, dev_images=imgs)
    batch = FrameBatch.from_detections(dets, times, board, 512, 512)
    result = calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(), gen,
        warm_provider=spec.take if speculate else None,
        device="cpu",
    )
    return result, spec, det, gen


def test_speculative_subsampled_matches_cold(seq24, monkeypatch):
    board, imgs = seq24
    monkeypatch.setattr(pipeline_mod, "SPEC_MAX_FRAMES", 8)  # stride 3
    (model_spec, _), spec, det, _ = _pipeline(board, imgs, True)
    assert det.stats["trigger_frames"] > 0 and spec.error is None
    warm = spec.take()
    assert warm is not None and np.all(warm[2] > 0)  # full-coverage seed
    assert calibrate_camera_with_retries.last_spec_used
    (model_cold, _), _, _, _ = _pipeline(board, imgs, False)
    np.testing.assert_allclose(model_spec.params, model_cold.params, rtol=1e-6, atol=1e-5)


def test_speculative_long_gap_keeps_pnp(seq24):
    board, imgs = seq24
    solved = [0, 1, 2, 19, 20, 21]
    dets = TagDetector("t36h11", track=False, device="cpu").detect_batch(
        None, board, dev_images=imgs[solved]
    )
    results = [dict() for _ in range(22)]
    for f, d in zip(solved, dets):
        results[f] = d
    spec = SpeculativeCalib(board, list(range(22)), zeros_like_model("eucm"),
                            CalibParams(), torch.Generator().manual_seed(7), 512, 512)
    spec.on_provisional(results)
    warm = spec.take()
    assert warm is not None and spec.error is None
    _, _, valid, _ = warm
    assert not np.all(valid > 0), "a 17-frame gap must not claim full coverage"
    assert set(np.flatnonzero(valid)) <= set(solved)


def test_speculative_pipeline_end_to_end(seq24):
    board, imgs = seq24
    (model_cold, _), _, _, gen_cold = _pipeline(board, imgs, False)
    (model_spec, _), spec, _, gen_spec = _pipeline(board, imgs, True)
    assert spec.take() is not None and spec.error is None
    assert calibrate_camera_with_retries.last_warm_offered
    assert calibrate_camera_with_retries.last_spec_used
    np.testing.assert_allclose(model_spec.params, model_cold.params, rtol=1e-6, atol=1e-5)
    # the warm trial drew nothing from the ladder's generator
    assert torch.equal(gen_spec.get_state(), torch.Generator().manual_seed(7).get_state())
    assert not torch.equal(gen_cold.get_state(), gen_spec.get_state())


def test_failed_warm_trial_leaves_the_ladder_unchanged(seq12):
    """A warm seed that fails the gate: the cold ladder then draws and
    returns exactly what it does without speculation."""
    board, batch, _ = seq12
    F = batch.p2d.shape[0]
    bad = GenericModel("eucm", [20.0, 20.0, 10.0, 10.0, 0.1, 5.0], 512, 512)
    poses = np.tile([0.0, 0.0, 0.0, 5.0, 5.0, 0.1], (F, 1))
    warm = (bad, poses, np.ones(F), (0, 1))

    def ladder(provider):
        gen = torch.Generator().manual_seed(11)
        res = calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(), gen,
            warm_provider=provider,
            device="cpu",
        )
        return res, gen.get_state()

    (m_cold, rt_cold), state_cold = ladder(None)
    assert not calibrate_camera_with_retries.last_warm_offered
    (m_warm, rt_warm), state_warm = ladder(lambda: warm)
    assert calibrate_camera_with_retries.last_warm_offered
    assert not calibrate_camera_with_retries.last_spec_used
    assert torch.equal(state_cold, state_warm)
    np.testing.assert_array_equal(m_warm.params, m_cold.params)
    assert sorted(rt_warm) == sorted(rt_cold)
    for i in rt_cold:
        np.testing.assert_array_equal(rt_warm[i].rvec, rt_cold[i].rvec)


def test_spec_error_is_kept_and_ladder_runs_cold(seq12, monkeypatch):
    board, batch, _ = seq12

    def broken(*a, **k):
        raise RuntimeError("solver exploded")

    gen = torch.Generator().manual_seed(5)
    spec = SpeculativeCalib(board, list(range(batch.n_frames)), zeros_like_model("eucm"),
                            CalibParams(), gen, 512, 512)
    monkeypatch.setattr(pipeline_mod, "init_and_calibrate_one_camera", broken)
    spec.on_provisional([{} for _ in range(batch.n_frames)])
    assert spec.take() is None
    assert spec.error == repr(RuntimeError("solver exploded"))
    monkeypatch.undo()
    model, _ = calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(), gen,
        warm_provider=spec.take,
        device="cpu",
    )
    assert not calibrate_camera_with_retries.last_warm_offered
    assert abs(model.params[0] - GT[0]) / GT[0] < 0.01


def test_concurrent_speculations_and_ladder(seq24, seq12):
    """Two speculations (torch.func Jacobians, float64 linalg) and a cold
    ladder on three threads at once, with a short switch interval, give
    exactly what each gives alone."""
    board, imgs = seq24
    dets = TagDetector("t36h11", track=False, device="cpu").detect_batch(None, board, dev_images=imgs)
    halves = [dets[:12], dets[12:]]
    _, batch12, _ = seq12

    def make_spec(seed):
        return SpeculativeCalib(board, list(range(12)), zeros_like_model("eucm"),
                                CalibParams(), torch.Generator().manual_seed(seed), 512, 512)

    def ladder():
        return calibrate_camera_with_retries(
            board, batch12, zeros_like_model("eucm"), CalibParams(),
            torch.Generator().manual_seed(2),
            device="cpu",
        )[0].params

    alone = []
    for k, h in enumerate(halves):
        s = make_spec(k)
        s.on_provisional(h)
        alone.append(s.take())
    ladder_alone = ladder()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        specs = [make_spec(k) for k in range(2)]
        for s, h in zip(specs, halves):
            s.on_provisional(h)
        box = {}
        t = threading.Thread(target=lambda: box.setdefault("p", ladder()))
        t.start()
        t.join(timeout=600)
        assert not t.is_alive()
        together = []
        for s in specs:
            s._thread.join(timeout=600)
            assert not s._thread.is_alive() and s.error is None
            together.append(s.take())
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(box["p"], ladder_alone)
    for a, b in zip(alone, together):
        assert a is not None and b is not None
        np.testing.assert_array_equal(a[0].params, b[0].params)
        np.testing.assert_array_equal(a[1], b[1])
