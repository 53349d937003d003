"""Card-only tests of the PyTorch port: the hand-written CUDA threshold
kernel against its plain torch version, the cold and the tracked detector
on the card against the CPU path, speculative calibration on the card
against the cold ladder, the CLI on the card against the CLI on the CPU,
the sharded solve and detection on every visible card (two shards of
the card when one is visible) against the unsharded ones, the warm-up
(exactly one kernel launch, nothing else changed) and the mixed-precision
solvers on the card against the CPU.  They skip without a CUDA device.

This file imports neither jax nor ``ccrs_tpu``, so it also runs on a
machine with the card and no JAX (``tests/conftest.py`` imports jax, hence
``--noconftest``)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect.threshold import threshold_front, threshold_front_plain
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.ops.threshold_cuda import threshold_front_cuda
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

torch.set_num_threads(1)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _frames(size, n, noise=0.0, device="cpu"):
    board = create_default_6x6_board()
    s = size / 512.0
    gt = GenericModel("eucm", [p * s for p in GT[:4]] + GT[4:], size, size)
    poses = smooth_sequence_poses(n, board, seed=3)
    gen = torch.Generator(device=device).manual_seed(3) if noise else None
    return render_frames_device(
        gt, board, get_family("t36h11"), poses, noise=noise, generator=gen,
        device=device,
    )


def _random(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,scale",
    [((3, 64, 128), 1), ((3, 479, 751), 1), ((3, 479, 751), 2),
     ((2, 500, 372), 1), ((2, 500, 372), 2), ((1, 7, 9), 1), ((1, 4, 8), 2)],
)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_matches_plain_random(card, shape, scale, dtype):
    """Bit-exact: every value of the threshold pipeline is exact in f32."""
    x = _random(shape, seed=shape[1]).to(dtype).to(card)
    if dtype == torch.float32:
        g = torch.Generator(device=card).manual_seed(1)
        x = x + 0.9 * torch.rand(shape, generator=g, device=card)
    before = threshold_front_cuda.launches
    got = threshold_front(x, scale)
    want = threshold_front_plain(x, scale)
    torch.cuda.synchronize()
    assert threshold_front_cuda.launches == before + 1
    assert got.device.type == "cuda" and torch.equal(got, want)


def _mixed(shape, seed):
    """Even frames full-range random, odd frames low-contrast (gray levels
    100..125), where the contrast test decides."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, np.uint8)
    x[1::2] = rng.integers(100, 126, x[1::2].shape, np.uint8)
    return torch.as_tensor(x)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,scale,min_contrast",
    [((2, 480, 752), 1, 20.0), ((2, 480, 752), 2, 20.0),  # EuRoC frames
     ((2, 480, 752), 1, 20.5), ((2, 480, 752), 2, 20.5),  # non-integer contrast
     ((2, 480, 752), 1, 0.0), ((2, 479, 751), 2, 0.0),    # zero contrast
     ((65600, 4, 8), 1, 20.0),                            # > 65,535 frames
     ((3, 40, 22), 2, 20.0), ((3, 41, 23), 2, 20.5)],     # narrower than a block
)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_matches_plain_edge_cases(card, shape, scale, min_contrast, dtype):
    x = _mixed(shape, seed=shape[0] + shape[2]).to(dtype).to(card)
    if dtype == torch.float32:
        g = torch.Generator(device=card).manual_seed(2)
        x = x + 0.9 * torch.rand(shape, generator=g, device=card)
    before = threshold_front_cuda.launches
    got = threshold_front(x, scale, min_contrast=min_contrast)
    want = threshold_front_plain(x, scale, min_contrast=min_contrast)
    torch.cuda.synchronize()
    assert threshold_front_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("size,scale", [(512, 1), (1024, 2)])
def test_kernel_is_one_launch_and_allocates_only_the_output(card, size, scale):
    """One call is one kernel launch (counted by the library where it
    launches), and the only memory it takes is the output (the caching
    allocator rounds to 512 B)."""
    from ccrs_tpu_torch.ops.threshold_cuda import kernel_launches

    x = _random((64, size, size)).to(card)
    threshold_front_cuda(x, scale)  # build and load the library first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    launched = kernel_launches()
    out = threshold_front_cuda(x, scale)
    torch.cuda.synchronize()
    assert kernel_launches() == launched + 1
    held = torch.cuda.memory_allocated(card) - base
    assert torch.cuda.max_memory_allocated(card) - base == held
    assert out.numel() <= held < out.numel() + 512


@pytest.mark.cuda
@pytest.mark.parametrize("size,scale", [(512, 1), (1024, 2)])
def test_kernel_matches_plain_boards(card, size, scale):
    x = _frames(size, 8, noise=1.5, device=card)
    got = threshold_front_cuda(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, threshold_front_plain(x, scale))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    x = _random((2, 64, 64)).to(card)
    with pytest.raises(TypeError):
        threshold_front_cuda(x.to(torch.int32))
    with pytest.raises(ValueError):
        threshold_front_cuda(x.mT)  # not contiguous
    with pytest.raises(ValueError):
        threshold_front_cuda(x, scale=3)


@pytest.mark.cuda
def test_detector_on_card_matches_cpu(card):
    frames = _frames(512, 6, noise=1.5)
    board = create_default_6x6_board()
    cpu = TagDetector("t36h11", track=False, device="cpu").detect_batch(None, board, dev_images=frames)
    gpu = TagDetector("t36h11", track=False, device=card).detect_batch(
        None, board, dev_images=frames.to(card)
    )
    for c, g in zip(cpu, gpu):
        assert sorted(c) == sorted(g)
        for t in c:
            np.testing.assert_allclose(g[t], c[t], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_tracked_detector_on_card_matches_cpu(card):
    """48 frames through the default (tracked) detector on the card and on
    the CPU: ids exact per frame, corners within 1e-3 px, equal stats; the
    threshold kernel launches inside the tracked run."""
    frames = _frames(512, 48, noise=1.5)
    board = create_default_6x6_board()
    cpu_det, gpu_det = TagDetector("t36h11", device="cpu"), TagDetector("t36h11", device=card)
    cpu = cpu_det.detect_batch(None, board, dev_images=frames)
    before = threshold_front_cuda.launches
    gpu = gpu_det.detect_batch(None, board, dev_images=frames.to(card))
    assert threshold_front_cuda.launches > before
    assert gpu_det.stats == cpu_det.stats and gpu_det.stats["waves"] > 0
    for c, g in zip(cpu, gpu):
        assert sorted(c) == sorted(g)
        for t in c:
            np.testing.assert_allclose(g[t], c[t], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_speculative_calibration_on_card_matches_cold(card):
    """Tracked detection with the speculation hook, then the ladder warm
    started from it, on the card: the cold ladder's optimum (RMS within
    1e-6 px), with no recorded speculation error."""
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
    from ccrs_tpu_torch.models import zeros_like_model
    from ccrs_tpu_torch.types import CalibParams

    frames = _frames(512, 24, noise=1.0, device=card)
    board = create_default_6x6_board()
    times = list(range(24))
    det = TagDetector("t36h11", device=card)
    spec = SpeculativeCalib(board, times, zeros_like_model("eucm"), CalibParams(),
                            torch.Generator(device=card).manual_seed(7), 512, 512)
    det.on_provisional = spec.on_provisional
    batch = FrameBatch.from_detections(
        det.detect_batch(None, board, dev_images=frames), times, board, 512, 512
    )

    def ladder(provider):
        return calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(),
            torch.Generator(device=card).manual_seed(7), warm_provider=provider,
            device=card,
        )

    warm = ladder(spec.take)
    assert spec.started and spec.error is None
    assert calibrate_camera_with_retries.last_spec_used
    cold = ladder(None)
    _, rms_warm = _rms_result(board, batch, *warm)
    _, rms_cold = _rms_result(board, batch, *cold)
    assert abs(rms_warm - rms_cold) < 1e-6, (rms_warm, rms_cold)
    np.testing.assert_allclose(warm[0].params, cold[0].params, rtol=1e-6, atol=1e-5)


def _rms_result(board, batch, model, rt):
    from ccrs_tpu_torch.calib.validate import reprojection_errors

    errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, model, rt)])
    return model, float(np.sqrt(np.mean(errs**2)))


def _cli(args, cwd):
    import contextlib
    import io
    import os

    from ccrs_tpu_torch.cli import main

    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(args)
    finally:
        os.chdir(old)


def _rms_of(out, batch, board):
    import json

    from ccrs_tpu_torch.calib.validate import reprojection_errors
    from ccrs_tpu_torch.types import RvecTvec

    model = GenericModel.from_json(json.loads((out / "cam0.json").read_text()))
    poses = json.loads((out / "cam0_poses.json").read_text())
    rt = {int(f): RvecTvec.from_json(v) for f, v in poses.items()}
    errs = np.concatenate([e for _, e, _ in reprojection_errors(board, batch, model, rt)])
    return model, float(np.sqrt(np.mean(errs**2)))


@pytest.mark.cuda
def test_cli_on_card_matches_cpu(card, tmp_path):
    """The CLI with --platform cuda on the CPU run's detections (its
    detection cache) lands on the CPU run's optimum within 1e-6 px RMS;
    a fresh card run (detection on the card) launches the kernel and
    agrees in fx within 1e-4 relative."""
    import glob

    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.testdata import write_euroc_dataset

    ds = str(tmp_path / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 512, 512), n_frames=16, seed=3, noise=1.5,
                        device="cpu")
    cache = str(tmp_path / "cache")
    base = [ds, "--model", "eucm", "--no-rerun", "--seed", "1"]
    _cli(base + ["--platform", "cpu", "--detection-cache", cache, "-o", "cpu"], tmp_path)
    _cli(base + ["--platform", "cuda", "--detection-cache", cache, "-o", "gpu"], tmp_path)
    before = threshold_front_cuda.launches
    _cli(base + ["--platform", "cuda", "-o", "fresh"], tmp_path)
    assert threshold_front_cuda.launches > before

    (cache_file,) = glob.glob(f"{cache}/cam0_*.npz")
    batch = FrameBatch.load(cache_file)
    board = create_default_6x6_board()
    m_cpu, rms_cpu = _rms_of(tmp_path / "cpu", batch, board)
    m_gpu, rms_gpu = _rms_of(tmp_path / "gpu", batch, board)
    assert abs(rms_cpu - rms_gpu) < 1e-6, (rms_cpu, rms_gpu)
    np.testing.assert_allclose(m_gpu.params, m_cpu.params, rtol=1e-5)
    m_fresh, _ = _rms_of(tmp_path / "fresh", batch, board)
    assert abs(m_fresh.params[0] - m_cpu.params[0]) / m_cpu.params[0] < 1e-4


def _card_mesh(card):
    """Every visible card, or two shards of the one card."""
    from ccrs_tpu_torch.parallel import mesh

    cards = mesh.make_mesh() if card.type == "cuda" else []
    return cards if len(cards) > 1 else [card, card]


@pytest.mark.cuda
def test_sharded_solve_on_the_cards(card):
    """make_ba_solver over every visible card (two shards of the card when
    one is visible) equals ba_solve on the card (theta 1e-9 relative) and
    the sharded solve on two CPU shards; multi_ba_sharded of a noiseless
    stereo problem with F = 23 (the padding path) equals ba_solve_multi on
    the card (theta 1e-8 relative, extrinsics 1e-8)."""
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.parallel import mesh
    from ccrs_tpu_torch.solve import se3
    from ccrs_tpu_torch.solve.lm import ba_solve, ba_solve_multi

    f64 = torch.float64
    rng = np.random.default_rng(2)
    board = create_default_6x6_board()
    gt = torch.tensor(GT, dtype=f64)
    poses = smooth_sequence_poses(24, board, seed=2)
    p3d = torch.as_tensor(board.p3d, dtype=f64)
    pc = se3.transform(torch.as_tensor(poses[:, :3], dtype=f64)[:, None],
                       torch.as_tensor(poses[:, 3:], dtype=f64)[:, None], p3d)[:, 0]
    p2d0, valid = project_eucm(gt, pc)
    p2d = p2d0 + torch.as_tensor(rng.normal(size=p2d0.shape) * 0.1)
    w = valid.to(f64)
    lo = torch.tensor([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6], dtype=f64)
    hi = torch.tensor([1e4, 1e4, 512.0, 512.0, 1.0, 10.0], dtype=f64)
    args = (gt * 1.02, torch.as_tensor(poses, dtype=f64) + 0.003, p3d, p2d, w, lo, hi,
            torch.ones(6, dtype=f64), torch.ones(24, dtype=f64))
    on_card = [a.to(card) for a in args]
    want = ba_solve(project_eucm, *on_card)
    got = mesh.make_ba_solver(project_eucm, _card_mesh(card))(*on_card)
    cpu = mesh.make_ba_solver(project_eucm, ["cpu", "cpu"])(*args)
    assert got.theta.device.type == card.type and got.poses.shape == (24, 6)
    np.testing.assert_allclose(got.theta.cpu().numpy(), want.theta.cpu().numpy(), rtol=1e-9)
    np.testing.assert_allclose(got.theta.cpu().numpy(), cpu.theta.numpy(), rtol=1e-9)
    np.testing.assert_allclose(got.theta.cpu().numpy(), GT, rtol=1e-2)

    ext1 = torch.tensor([0.02, -0.015, 0.005, -0.11, 0.002, 0.004], dtype=f64)
    pt = torch.as_tensor(poses, dtype=f64)
    rv, tv = se3.compose(ext1[:3].expand(24, 3), ext1[3:].expand(24, 3), pt[:, :3], pt[:, 3:])
    p2d1, valid1 = project_eucm(gt, se3.transform(rv[:, None], tv[:, None], p3d)[:, 0])
    F, ones = 23, torch.ones((2, 6), dtype=f64)
    jargs = (torch.stack([gt * 1.02, gt * 0.99]),
             torch.stack([torch.zeros(6, dtype=f64), ext1 + 2e-3]), pt[:F] + 0.003, p3d,
             torch.stack([p2d0, p2d1])[:, :F], torch.stack([w, valid1.to(f64)])[:, :F],
             lo.expand(2, 6), hi.expand(2, 6), ones, torch.ones((2, F), dtype=f64),
             torch.ones(F, dtype=f64))
    on_card = [a.to(card) for a in jargs]
    want = ba_solve_multi(project_eucm, *on_card)
    got = mesh.multi_ba_sharded(project_eucm, *on_card, mesh=_card_mesh(card))
    assert got.poses.shape == (F, 6)
    np.testing.assert_allclose(got.theta.cpu().numpy(), want.theta.cpu().numpy(), rtol=1e-8)
    np.testing.assert_allclose(got.ext.cpu().numpy(), want.ext.cpu().numpy(), rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
def test_sharded_detect_on_the_cards(card, track):
    """TagDetector on a mesh of every visible card (two shards of the card
    when one is visible) shards by default, equals the unsharded detector
    bit for bit; cold, it launches the kernel on every shard."""
    from ccrs_tpu_torch.parallel import mesh

    board = create_default_6x6_board()
    cards = _card_mesh(card)
    frames = _frames(512, 8 * len(cards), noise=1.5).to(card)
    base = TagDetector("t36h11", track=track, shard=False).detect_batch(
        None, board, dev_images=frames)
    with mesh.default_mesh(cards):
        det = TagDetector("t36h11", track=track)
        before = threshold_front_cuda.launches
        sh = det.detect_batch(None, board, dev_images=frames)
    # cold: one chunk per shard; tracked: the anchor and audit sweeps' shards
    assert threshold_front_cuda.launches - before >= (1 if track else len(cards))
    for f, (a, b) in enumerate(zip(base, sh)):
        assert sorted(a) == sorted(b), f"frame {f}"
        for tid in a:
            np.testing.assert_array_equal(a[tid], b[tid])


@pytest.mark.cuda
@pytest.mark.parametrize("track", [True, False])
def test_prewarm_on_the_card_launches_once_and_changes_nothing(card, track):
    """TagDetector.prewarm on the card: exactly one threshold kernel launch
    (the wrapper's count, the library's and ``prewarm_launches``, which is
    this thread's share of the wrapper's count, agree), the
    detector's state untouched, and the detections that follow equal to a
    detector's that never warmed up."""
    from ccrs_tpu_torch.ops.threshold_cuda import kernel_launches

    board = create_default_6x6_board()
    frames = _frames(512, 8, noise=1.5, device="cuda")
    want = TagDetector("t36h11", track=track, device="cuda").detect_batch(
        None, board, dev_images=frames
    )
    det = TagDetector("t36h11", track=track, device="cuda")
    n0, c0 = threshold_front_cuda.launches, kernel_launches()
    det.prewarm(512, 512, board, n_frames=8)
    assert threshold_front_cuda.launches - n0 == kernel_launches() - c0 == 1
    assert det.prewarm_launches == 1 and det.stats == {} and det._tstate is None
    got = det.detect_batch(None, board, dev_images=frames)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            np.testing.assert_array_equal(g[t], w[t])


@pytest.mark.cuda
@pytest.mark.parametrize("speculative", [False, True])
def test_prewarm_calibration_on_the_card(card, speculative):
    """prewarm_calibration runs on the card for both solver routes and
    leaves the global generators alone."""
    from ccrs_tpu_torch.calib.prewarm import prewarm_calibration

    state, cuda_state = torch.get_rng_state(), torch.cuda.get_rng_state()
    for solver in ("f64", "mixed"):
        prewarm_calibration(create_default_6x6_board(), 300, "eucm", None, 752, 480,
                            speculative=speculative, n_frames_spec=640, device="cuda",
                            solver=solver)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(torch.cuda.get_rng_state(), cuda_state)


@pytest.mark.cuda
def test_mixed_solvers_on_the_card_match_the_cpu(card):
    """The rig problem at a small size: the float64 and the mixed solve on
    the card land where the CPU's float64 solve lands (RMS within 1e-6 px),
    a float32-Jacobian solve of camera 0 on the card equals the CPU's, the
    float32 stage stays float32 on the card, and
    the sharded mixed solve (two shards of the card) equals the unsharded
    one within 1e-8 relative."""
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.parallel.mesh import make_mesh, multi_ba_sharded_mixed
    from ccrs_tpu_torch.solve.lm import ba_solve, ba_solve_multi, ba_solve_multi_mixed
    from ccrs_tpu_torch.testdata import rig_errors, rig_problem

    cpu = rig_problem(3, 40, seed=1, device="cpu")
    # generated on the card: the same problem up to the trig functions' last
    # bits (measured 2.8e-8 px); the solves below take identical inputs
    for a, b in zip(cpu["args"], rig_problem(3, 40, seed=1, device="cuda")["args"]):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0, atol=1e-6)
    gpu = dict(cpu, args=tuple(a.cuda() for a in cpu["args"]))
    ref = rig_errors(cpu, ba_solve_multi(project_eucm, *cpu["args"]))
    assert 0.07 < ref["rms_px"] < 0.13
    mixed = ba_solve_multi_mixed(project_eucm, *gpu["args"])
    assert mixed.theta.is_cuda and mixed.theta.dtype == torch.float64 and mixed.n_polish > 0
    for res in (ba_solve_multi(project_eucm, *gpu["args"]), mixed):
        assert abs(rig_errors(gpu, res)["rms_px"] - ref["rms_px"]) < 1e-6
    # float32 Jacobians.  Joint: the composed rotation of a board that faces
    # the rig is close to pi, where the float32 log map's derivative is off
    # (tests/test_torch_mixed.py holds that against the JAX package), so the
    # solve stalls above the optimum; the card takes the CPU's first step.
    s_cpu = ba_solve_multi(project_eucm, *cpu["args"], max_iters=1, jac_f32=True)
    s_gpu = ba_solve_multi(project_eucm, *gpu["args"], max_iters=1, jac_f32=True)
    np.testing.assert_allclose(float(s_gpu.cost), float(s_cpu.cost), rtol=0.01)
    # Single camera (no composition): camera 0's problem on the card
    # against the CPU, theta within 1e-6
    def cam0(args):
        th, _, po, p3d, p2d, w, lo, hi, free, cfv, fv = args
        return th[0], po, p3d, p2d[0], w[0], lo[0], hi[0], free[0], fv * cfv[0]

    j_cpu = ba_solve(project_eucm, *cam0(cpu["args"]), jac_f32=True)
    j_gpu = ba_solve(project_eucm, *cam0(gpu["args"]), jac_f32=True)
    np.testing.assert_allclose(j_gpu.theta.cpu().numpy(), j_cpu.theta.numpy(), rtol=1e-6)
    f32 = ba_solve_multi(
        project_eucm, *(a.to(torch.float32) for a in gpu["args"]), rtol=1e-6
    )
    assert {f32.theta.dtype, f32.ext.dtype, f32.poses.dtype, f32.cost.dtype} == {torch.float32}
    mesh = make_mesh()
    if len(mesh) == 1:
        mesh = [mesh[0], mesh[0]]
    sharded = multi_ba_sharded_mixed(project_eucm, *gpu["args"], mesh=mesh)
    rel = float(((sharded.theta - mixed.theta).abs() / mixed.theta.abs()).max())
    assert rel < 1e-8, rel
