"""Card-only tests of the PyTorch port: the hand-written CUDA threshold
kernel against its plain torch version, the cold and the tracked detector
on the card against the CPU path, speculative calibration on the card
against the cold ladder, the CLI on the card against the CLI on the CPU,
and the sharded solve and detection on every visible card (two shards of
the card when one is visible) against the unsharded ones.  They skip without a CUDA device.

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
