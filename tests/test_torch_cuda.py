"""Card-only tests of the PyTorch port: the hand-written CUDA threshold
kernel against its plain torch version, the cold and the tracked detector
on the card against the CPU path, speculative calibration on the card
against the cold ladder, the CLI on the card against the CLI on the CPU,
the sharded solve and detection on every visible card (two shards of
the card when one is visible) against the unsharded ones, the warm-up
(exactly one kernel launch, nothing else changed), the mixed-precision
solvers on the card against the CPU, and the cold detector's chunk
pipeline against the same chunks detected one per call, bit for bit, also
with the stream held back by sleep kernels, and its peak memory flat in
the batch size; the native quad stage on the kernel's bitmaps against the
numpy composition it replaced, bit for bit, alone and inside a tracked
detection; the sampling branch's constants made once per device, and
a 64-frame chunk through the matmul branch without a synchronizing call;
the captured CUDA graphs of the detect path (``detect/graphs.py``, the
card's default) against eager, bit for bit, a capture that synchronizes
raising, a second warm run capturing nothing, and sharded detection under
graphs; calibration's captured graphs (``solve/lm.py``'s device loop and
``graphs.call``) against eager, bit for bit, a second solve capturing
nothing, a chunk without a synchronizing call, two threads solving one
shape at once, a solver capture beside device-wide synchronizes, and the
calibration warm-up capturing nothing; the frame-sharded LM's per-shard
graphs (``lm.shard_graphs``, the route of a mesh over several cards) over
two shards of the card and over every visible card against the eager
sharded route, bit for bit, a second solve capturing nothing, the copies
between phases ordered behind delayed sources, and ``graphs.keep``
bounding each card's graphs.  The card-vs-CPU comparisons run the CPU side in the card's sampling branch
(``sample.matmul_branch``).  They skip without a CUDA device.

This file imports neither jax nor ``ccrs_tpu``, so it also runs on a
machine with the card and no JAX (``tests/conftest.py`` imports jax, hence
``--noconftest``)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family, graphs, sample
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


def _card_branch(card):
    """The sampling branch the card takes by default: the CPU side of a
    card-vs-CPU comparison runs it too (``sample.matmul_branch``)."""
    return sample._use_mm(None, torch.empty(0, device=card))


@pytest.mark.cuda
def test_detector_on_card_matches_cpu(card):
    frames = _frames(512, 6, noise=1.5)
    board = create_default_6x6_board()
    with sample.matmul_branch(_card_branch(card)):
        cpu = TagDetector("t36h11", track=False, device="cpu").detect_batch(
            None, board, dev_images=frames)
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
    the CPU (in the card's sampling branch): ids exact per frame, corners
    within 1e-3 px, equal stats; the threshold kernel launches inside the
    tracked run."""
    frames = _frames(512, 48, noise=1.5)
    board = create_default_6x6_board()
    cpu_det, gpu_det = TagDetector("t36h11", device="cpu"), TagDetector("t36h11", device=card)
    with sample.matmul_branch(_card_branch(card)):
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


#: EuRoC cam0 (the reference example's UCM) written as EUCM with beta = 1
EUROC_CAM0 = [471.019, 470.243, 367.122, 246.741, 0.67485, 1.0]
#: cycles of the sleep kernel queued before each upload of the delayed run
#: (about 10 ms at the H100's clocks), and before its first chunk
UPLOAD_SLEEP = 20_000_000


def _camera_frames(n, device):
    """n noisy frames of one 752x480 EuRoC-like camera (EUCM), uint8."""
    board = create_default_6x6_board()
    gt = GenericModel("eucm", EUROC_CAM0, 752, 480)
    poses = smooth_sequence_poses(n, board, seed=4)
    return render_frames_device(
        gt, board, get_family("t36h11"), poses, noise=1.5,
        generator=torch.Generator(device=device).manual_seed(4), device=device,
    )


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            np.testing.assert_array_equal(g[t], w[t])


def _chunk_by_chunk(det, board, frames):
    """The cold detector on each chunk of its plan in a call of its own
    (the same chunk boundaries, no overlap between chunks)."""
    return [r for lo, n in det._spans(frames.shape[0])
            for r in det._detect_batch_cold(frames[lo : lo + n], board)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["graphs", "eager"])
@pytest.mark.parametrize("shape", ["534x512x512", "534x512x512-jax-plan", "640x480x752"])
def test_cold_pipeline_on_the_card_equals_chunk_by_chunk(card, shape, mode, monkeypatch):
    """The three-phase pipeline on the card gives the bits of the same
    chunks detected one per call.  Eagerly 534 frames run as 8 x 64 + 22,
    and under ``CCRS_FORCE_CHUNK_PLAN`` (the JAX accelerator plan) as 8 x
    64 + 8 + 8 + 6; with graphs (the card's default) always as the JAX
    plan, whose last piece's threshold sees its 6 real frames."""
    from ccrs_tpu_torch.detect import detector as TD

    if shape == "534x512x512":
        frames, plan = _frames(512, 534, noise=1.5, device="cuda"), [64] * 8 + [22]
    elif shape == "534x512x512-jax-plan":
        monkeypatch.setenv("CCRS_FORCE_CHUNK_PLAN", "1")
        frames, plan = _frames(512, 534, noise=1.5, device="cuda"), [64] * 8 + [8, 8, 6]
    else:
        frames, plan = _camera_frames(640, "cuda"), [64] * 10
    if mode == "graphs" and shape == "534x512x512":
        plan = [64] * 8 + [8, 8, 6]
    board = create_default_6x6_board()
    # one device's pipeline: with several cards visible the detector would
    # shard the batch by default, and each shard takes its own plan
    det = TagDetector("t36h11", track=False, shard=False, device=card)
    sizes = []
    real = TD.threshold_front
    monkeypatch.setattr(TD, "threshold_front",
                        lambda part, scale: sizes.append(part.shape[0]) or real(part, scale))
    with graphs.eager(mode == "eager"):
        got = det.detect_batch(None, board, dev_images=frames)
        assert sizes == plan
        _same_bits(got, _chunk_by_chunk(det, board, frames))
    assert sum(len(g) for g in got) > 10 * len(got)


@pytest.mark.cuda
@pytest.mark.parametrize("audit", [False, True], ids=["contiguous", "idx"])
def test_cold_pipeline_on_a_delayed_card_gives_the_same_bits(card, audit, monkeypatch):
    """A sleep kernel queued before the first chunk and before every upload
    holds the stream: a host copy read before its event completed, or a
    pinned upload source freed before its copy ran, would change the bits."""
    from ccrs_tpu_torch.detect import detector as TD

    frames = _frames(512, 96, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    idx = np.random.default_rng(0).permutation(96)[:70] if audit else None
    det = TagDetector("t36h11", track=False, device=card)
    want = det._detect_batch_cold(frames, board, idx=idx)
    real = TD._to_device

    def delayed_upload(arr, device):
        torch.cuda._sleep(UPLOAD_SLEEP)
        return real(arr, device)

    monkeypatch.setattr(TD, "_to_device", delayed_upload)
    torch.cuda.synchronize()
    torch.cuda._sleep(10 * UPLOAD_SLEEP)
    got = det._detect_batch_cold(frames, board, idx=idx)
    _same_bits(got, want)
    assert sum(len(g) for g in got) > 20 * len(got)


def _numpy_quad_stage(b1, board, scale, max_quads):
    """The quad stage as numpy around two native calls, the composition of
    the JAX package's ``TagDetector._extract_quads`` (which
    ``tests/test_torch_quad_stage.py`` holds the native stage to on the
    CPU): level 1, the level-2 need rule, a 3x3 white dilation, level 2,
    the scale-2 corner push, the merge, the scale-2 pixel map."""
    from ccrs_tpu_torch.detect.quads import extract_quads_batch

    half = max_quads // 2
    q1, c1 = extract_quads_batch(b1, max_quads=half)
    q2, c2 = np.zeros_like(q1), np.zeros_like(c1)
    need = []
    for b in range(b1.shape[0]):
        n1 = int(c1[b])
        if board is None or n1 < board.n_tags:
            need.append(b)
            continue
        x, y = q1[b, :n1, :, 0], q1[b, :n1, :, 1]
        a2 = (np.einsum("qn,qn->q", x, np.roll(y, -1, 1))
              - np.einsum("qn,qn->q", np.roll(x, -1, 1), y))
        if 0.5 * np.abs(a2).max() >= (100.0 / scale) ** 2:
            need.append(b)
    need = np.asarray(need, np.int64)
    if need.size:
        b2 = b1[need].copy()
        b2[:, 1:, :] |= b1[need][:, :-1, :]
        b2[:, :-1, :] |= b1[need][:, 1:, :]
        col = b2.copy()
        b2[:, :, 1:] |= col[:, :, :-1]
        b2[:, :, :-1] |= col[:, :, 1:]
        q2[need], c2[need] = extract_quads_batch(b2, max_quads=half)

    def expand(q, px):
        d = q - q.mean(axis=2, keepdims=True)
        return q + d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6) * px

    if scale == 2:
        q1, q2 = expand(q1, 1.5), expand(q2, 2.75)
    k = np.arange(half)[None, :]
    m1, m2 = k < c1[:, None], k < c2[:, None]
    cen1, cen2 = q1.mean(axis=2), q2.mean(axis=2)
    rad1 = np.linalg.norm(q1 - cen1[:, :, None, :], axis=-1).mean(axis=2)
    d = np.linalg.norm(cen1[:, None, :, :] - cen2[:, :, None, :], axis=-1)
    keep2 = m2 & ~((d < 0.7 * rad1[:, None, :]) & m1[:, None, :]).any(axis=2)
    valid = np.concatenate([m1, keep2], axis=1)
    order = np.argsort(~valid, axis=1, kind="stable")
    rows = np.take_along_axis(np.concatenate([q1, q2], axis=1), order[:, :, None, None], axis=1)
    quads = np.zeros((q1.shape[0], max_quads, 4, 2), np.float32)
    quads[:, : min(max_quads, 2 * half)] = rows[:, :max_quads]
    counts = np.minimum(valid.sum(axis=1), max_quads).astype(np.int32)
    if scale == 2:
        quads = quads * 2.0 + 0.5
    return quads, counts, int(need.size)


@pytest.mark.cuda
def test_native_quad_stage_equals_the_numpy_composition_on_card_bitmaps(card, monkeypatch):
    """On the threshold kernel's bitmaps of a rendered 512² sequence the
    native quad stage gives the numpy composition's quads and counts, bit
    for bit, with and without a board; and a tracked ``detect_batch`` of
    the sequence with the numpy composition in the stage's place returns
    the same bits."""
    from ccrs_tpu_torch.detect.quads import extract_quad_stage

    frames = _frames(512, 96, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    packed = threshold_front_cuda(frames, 1).cpu().numpy()
    b1 = np.unpackbits(packed, axis=-1)[:, :512, :512]
    for bd in (board, None):
        q, c, level2 = extract_quad_stage(packed, 512, 512, 1, None if bd is None else bd.n_tags)
        rq, rc, rlevel2 = _numpy_quad_stage(b1, bd, 1, q.shape[1])
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(q.view(np.uint32), rq.view(np.uint32))
        assert level2 == rlevel2 and (bd is not None or level2 == 96)
    det = TagDetector("t36h11", shard=False, device=card)
    got = det.detect_batch(None, board, dev_images=frames)
    stats = dict(det.stats)

    def numpy_stage(self, packed, board, scale, height, width):
        bits = np.unpackbits(packed, axis=-1)[:, :height, :width]
        return _numpy_quad_stage(bits, board, scale, self.max_quads)

    monkeypatch.setattr(TagDetector, "_extract_quads", numpy_stage)
    ref = TagDetector("t36h11", shard=False, device=card)
    want = ref.detect_batch(None, board, dev_images=frames)
    assert ref.stats == stats and stats["cold_frames"] > 0
    _same_bits(got, want)


@pytest.mark.cuda
def test_cold_pipeline_peak_memory_does_not_grow_with_the_batch(card):
    """Phase 2 runs one chunk behind phase 1, so at most two chunks' KLT
    maps (448 MiB each at 64 x 512^2) are alive: the peak above the frames
    is the same within 256 MiB for 128 and for 384 frames."""
    frames = _frames(512, 384, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    det = TagDetector("t36h11", track=False, device=card)
    # warm: with graphs (the default) every decode graph these frames
    # need is captured here, its maps in its own pool
    det._detect_batch_cold(frames, board)
    peak = {}
    for n in (128, 384):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        det._detect_batch_cold(frames[:n], board)
        torch.cuda.synchronize()
        peak[n] = (torch.cuda.max_memory_allocated() - base) / 2**20
    assert peak[384] - peak[128] < 256, peak


@pytest.mark.cuda
def test_sampling_constants_made_once_per_device(card):
    """The band matrices and pixel grids are made once per device: a
    second pass of the same shapes through the four functions makes none."""
    frames = _frames(512, 4, noise=1.5, device="cuda")
    dev = frames.device
    start = torch.full((4, 8, 2), 100.0, device=dev)

    def one_pass():
        sharp = sample.unsharp_mm(frames, use_matmul=True)
        maps = sample.build_klt_maps(frames, use_matmul=True)
        sample.refine_corners_mm(maps, start, use_matmul=True)
        sample.sample_bilinear_mm(sharp, start[..., 0], start[..., 1], use_matmul=True)

    one_pass()
    made = (sample._band.cache_info().currsize, sample._grid.cache_info().currsize)
    blur = sample._band(512, "blur", True, dev)
    one_pass()
    assert (sample._band.cache_info().currsize, sample._grid.cache_info().currsize) == made
    assert sample._band(512, "blur", True, dev) is blur and blur.device == dev


@pytest.mark.cuda
def test_matmul_chunk_makes_no_synchronizing_call(card, monkeypatch):
    """A 64-frame 512x512 chunk of the eager cold detector runs to its end under
    ``set_sync_debug_mode("error")`` through the matmul branch (the second
    chunk of its shape; its hat weights were built), and a blocking
    ``.item()`` after it raises."""
    frames = _frames(512, 64, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    det = TagDetector("t36h11", track=False, device=card)
    hats = []
    real = sample._hat
    monkeypatch.setattr(sample, "_hat", lambda *a: hats.append(1) or real(*a))
    with sample.matmul_branch(True), graphs.eager():
        want = det.detect_batch(None, board, dev_images=frames)
        torch.cuda.synchronize()
        n_hats = len(hats)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = det.detect_batch(None, board, dev_images=frames)
            with pytest.raises(RuntimeError, match="synchronizing"):
                torch.ones(1, device=card).item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert n_hats > 0 and len(hats) == 2 * n_hats
    _same_bits(got, want)


def _decode_calls(det, board, frames, monkeypatch):
    """The args of every refine_decode_fused_dense call of one eager cold
    detection of ``frames`` (the primary decode first, then the assist)."""
    from ccrs_tpu_torch.detect import detector as TD

    calls = []
    real = TD.refine_decode_fused_dense
    with monkeypatch.context() as m:
        m.setattr(TD, "refine_decode_fused_dense",
                  lambda *a, **k: calls.append((a, k)) or real(*a, **k))
        with graphs.eager():
            det.detect_batch(None, board, dev_images=frames)
    return calls


@pytest.mark.cuda
def test_graphs_equal_eager_on_a_chunk_and_a_wave(card, monkeypatch):
    """One 64-frame 512x512 chunk: the captured primary decode and the
    assist decode that reads its maps in place give the eager calls' bits
    (every output, the maps and sharpened frames included), and so does
    the cold detector through them; one wave of the tracked detector: the
    graph of ``wave_step`` gives ``wave_advance``'s outputs and carry.
    Then the whole tracked detection of 96 frames, graphed (padded rows,
    the JAX plan's pieces) against eager (natural shapes): equal bits."""
    from ccrs_tpu_torch.detect import detector as TD
    from ccrs_tpu_torch.detect import track as TT
    from ccrs_tpu_torch.detect import tracked as TTR

    frames = _frames(512, 96, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    det = TagDetector("t36h11", track=False, device=card)
    calls = _decode_calls(det, board, frames[:64].contiguous(), monkeypatch)
    (fam, images, quads, qvalid), kw = calls[0]
    (_, _, aq, av), akw = next(c for c in calls if c[1].get("maps") is not None)
    want = TD.refine_decode_fused_dense(fam, images, quads, qvalid, **kw)
    got = graphs.run(TD._decode_graph, (fam, True), (images, quads, qvalid), pool="test")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    awant = TD.refine_decode_fused_dense(fam, images, aq, av, do_refine=True,
                                         sharp=want["sharp"], maps=want["maps"])
    agot = graphs.run(TD._assist_graph, (fam, True), (aq, av),
                      bound=(got["sharp"], got["maps"]), pool="test")
    for k in ("tag_id", "hamming", "valid", "corners"):
        assert torch.equal(agot[k], awant[k]), k
    with graphs.eager():
        eager = det.detect_batch(None, board, dev_images=frames[:64])
    _same_bits(det.detect_batch(None, board, dev_images=frames[:64]), eager)

    waves = []
    real = TTR.wave_advance
    monkeypatch.setattr(TTR, "wave_advance", lambda *a: waves.append(a) or real(*a))
    with graphs.eager():
        eager = TagDetector("t36h11", device=card).detect_batch(None, board, dev_images=frames)
    monkeypatch.setattr(TTR, "wave_advance", real)
    fam, imgs, bxy, first, carry, act = waves[0]
    want_carry, want = TT.wave_advance(fam, imgs, bxy, first, carry, act)
    g = graphs.get(TT.wave_step, (fam, first), (imgs, bxy, act, *carry), pool="test-wave")
    for buf, t in zip(g.inputs, (imgs, bxy, act, *carry)):
        buf.copy_(t)
    outs = g.replay()
    for a, b in zip(tuple(outs) + tuple(g.inputs[3:]), want + want_carry):
        assert torch.equal(a, b)
    _same_bits(TagDetector("t36h11", device=card).detect_batch(None, board, dev_images=frames),
               eager)


@pytest.mark.cuda
def test_capture_that_synchronizes_raises(card):
    """A function that reads a value back to the host (``.item()``)
    cannot be captured: ``graphs.get`` raises, counts no capture, and
    captures the next function as before."""
    x = torch.arange(4.0, device=card)
    before = graphs.counts()["captures"]

    def reads_back(a):
        return a * a.sum().item()

    with pytest.raises(RuntimeError):
        graphs.get(reads_back, (), (x,))
    assert graphs.counts()["captures"] == before
    torch.cuda.synchronize()

    def doubles(a):
        return a * 2

    out = graphs.run(doubles, (), (x,))
    assert graphs.counts()["captures"] == before + 1
    assert torch.equal(out, x * 2)
    assert torch.equal(graphs.run(doubles, (), (x + 1,)), (x + 1) * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("track", [True, False])
def test_second_warm_run_captures_nothing(card, track):
    """The same 150 frames through one detector twice: the second run
    replays every graph it runs and captures none, and detects the same
    bits."""
    frames = _frames(512, 150, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    det = TagDetector("t36h11", track=track, device=card)
    first = det.detect_batch(None, board, dev_images=frames)
    det.reset_tracking()
    graphs.reset_counts()
    again = det.detect_batch(None, board, dev_images=frames)
    counts = graphs.counts()
    assert counts["captures"] == 0 and counts["replays"] > 0, counts
    _same_bits(again, first)


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
def test_sharded_detect_under_graphs_equals_unsharded_and_eager(card, track):
    """With graphs, the detector on the mesh (two shards of the card when
    one is visible) equals the unsharded one and the eager one, bit for
    bit, and replays graphs."""
    from ccrs_tpu_torch.parallel import mesh

    board = create_default_6x6_board()
    cards = _card_mesh(card)
    frames = _frames(512, 24 * len(cards), noise=1.5).to(card)
    with graphs.eager():
        eager = TagDetector("t36h11", track=track, shard=False).detect_batch(
            None, board, dev_images=frames)
    base = TagDetector("t36h11", track=track, shard=False).detect_batch(
        None, board, dev_images=frames)
    graphs.reset_counts()
    with mesh.default_mesh(cards):
        sh = TagDetector("t36h11", track=track).detect_batch(None, board, dev_images=frames)
    assert graphs.counts()["replays"] > 0
    _same_bits(sh, base)
    _same_bits(base, eager)


@pytest.mark.cuda
def test_graphs_beside_other_threads(card):
    """The warm-up on a thread of its own while this thread synchronizes
    the whole device in a loop (``bench_torch.py`` synchronizes beside its
    warm-up threads): no error on either side, since the warm-up captures
    no graph.  Then a first detection, which captures its graphs while
    another thread reads values back (``.item()``, as the speculation
    thread does): no error, and the bits of eager detection."""
    import threading

    graphs.reset()
    frames = _frames(512, 64, noise=1.5, device="cuda")
    board = create_default_6x6_board()
    det = TagDetector("t36h11", device=card)
    errors = []

    def warm():
        try:
            det.prewarm(512, 512, board, n_frames=64)
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=warm)
    t.start()
    while t.is_alive():
        torch.cuda.synchronize()
    t.join()
    assert not errors and graphs.counts()["graphs"] == 0
    stop = threading.Event()

    def read_back():
        x = torch.ones(4096, device=card)
        while not stop.is_set():
            try:
                (x * 2).sum().item()
            except Exception as e:  # reported below
                errors.append(e)
                return

    r = threading.Thread(target=read_back)
    r.start()
    graphs.reset_counts()
    try:
        got = det.detect_batch(None, board, dev_images=frames)
    finally:
        stop.set()
        r.join()
    assert not errors and graphs.counts()["captures"] > 0
    with graphs.eager():
        want = TagDetector("t36h11", device=card).detect_batch(None, board, dev_images=frames)
    _same_bits(got, want)


# --------------------------------------------------------------------------
# calibration's captured graphs (solve/lm.py's device loop, graphs.call)
# --------------------------------------------------------------------------


def _calib_problem(F, seed, device):
    """A FrameBatch of ``F`` views of the board through a TUM-VI-like EUCM
    camera (0.3 px noise), its true poses and the board."""
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.types import RvecTvec

    board = create_default_6x6_board()
    gt = GenericModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(F, board, seed=seed)
    rng = np.random.default_rng(seed)
    p2d = np.zeros((F, board.n_corners, 2))
    mask = np.zeros((F, board.n_corners), bool)
    for f, pose in enumerate(poses):
        p, valid = gt.project(RvecTvec(pose[:3], pose[3:]).transform(board.p3d))
        inside = (p[:, 0] >= 0) & (p[:, 0] < 512) & (p[:, 1] >= 0) & (p[:, 1] < 512)
        mask[f] = valid & inside
        p2d[f] = np.where(mask[f][:, None], p + rng.normal(size=p.shape) * 0.3, 0.0)
    return board, FrameBatch(np.arange(F), p2d, mask, 512, 512), poses


def _ba_args(batch, poses, board, device, scale=1.01):
    from ccrs_tpu_torch.calib.single import build_bounds

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64, device=device)

    lo, hi = build_bounds(GenericModel("eucm", GT, 512, 512), False)
    F = batch.n_frames
    return (t(np.array(GT) * scale), t(poses + 1e-3), t(board.p3d), t(batch.p2d),
            t(batch.mask), t(lo), t(hi), t(np.ones(6)), t(np.ones(F)))


def _solver_bits(out):
    """Every number of a solver result, as numpy arrays."""
    if out is None:
        return [np.array([np.nan])]
    if isinstance(out, GenericModel):
        return [out.params]
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], GenericModel):
        model, rtvecs = out
        return [model.params, np.array(sorted(rtvecs), float)] + [
            np.concatenate([rtvecs[f].rvec, rtvecs[f].tvec]) for f in sorted(rtvecs)]
    return [t.cpu().numpy() for t in out[:3]] + [np.array(out.n_iters)]


def _same_solver_bits(got, want):
    got, want = _solver_bits(got), _solver_bits(want)
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        for a, b in zip(got, want))


@pytest.fixture(scope="module")
def solver_cases():
    """name -> a solve on the card, each a path the calibration takes."""
    from ccrs_tpu_torch.calib import calib_camera
    from ccrs_tpu_torch.calib.convert import convert_model
    from ccrs_tpu_torch.calib.initialize import find_best_two_frames, try_init_camera
    from ccrs_tpu_torch.models import zeros_like_model
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.solve import lm
    from ccrs_tpu_torch.testdata import rig_problem

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured on the card")
    board, batch, poses = _calib_problem(64, 5, "cpu")
    args = _ba_args(batch, poses, board, "cuda")
    rig = rig_problem(3, 40, seed=1, device="cuda")["args"]
    f0, f1 = find_best_two_frames(batch)
    seed = GenericModel("eucm", np.array(GT) * [1.02, 0.99, 1, 1, 0.97, 1.02], 512, 512)
    warm_valid = np.ones(batch.n_frames)
    warm_valid[::3] = 0.0

    def convert():
        src = GenericModel("ucm", [190.5, 190.2, 255.2, 256.1, 0.63], 512, 512)
        tgt = zeros_like_model("kb4", 512, 512)
        convert_model(src, tgt, device="cuda")
        return tgt

    return {
        "ba_solve": lambda: lm.ba_solve(project_eucm, *args),
        "ba_solve_mixed": lambda: lm.ba_solve_mixed(project_eucm, *args),
        "ba_solve_multi": lambda: lm.ba_solve_multi(project_eucm, *rig),
        "lm_solve grid fit": convert,
        "try_init_camera": lambda: try_init_camera(
            board, batch, f0, f1, torch.Generator(device="cuda").manual_seed(3),
            device="cuda"),
        "calib_camera cold": lambda: calib_camera(board, batch, seed, False, 0, False,
                                                  device="cuda"),
        "calib_camera warm": lambda: calib_camera(
            board, batch, seed, False, 0, False, warm_poses=poses + 1e-3,
            warm_valid=warm_valid, device="cuda"),
        "calib_camera skip_pose_init": lambda: calib_camera(
            board, batch, seed, False, 0, False, warm_poses=poses + 1e-3,
            warm_valid=np.ones(batch.n_frames), skip_pose_init=True, device="cuda"),
        "calib_camera speculative": lambda: calib_camera(
            board, batch, seed, False, 0, False, polish_iters=2, pose_init_f32=True,
            device="cuda"),
    }


SOLVER_CASES = ("ba_solve", "ba_solve_mixed", "ba_solve_multi", "lm_solve grid fit",
                "try_init_camera", "calib_camera cold", "calib_camera warm",
                "calib_camera skip_pose_init", "calib_camera speculative")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SOLVER_CASES)
def test_solver_graphs_equal_eager(card, solver_cases, name):
    """Graphed (the card's default) against eager (``graphs.eager()``):
    every number of the result and the LM iterations equal bit for bit;
    the graphed run replays graphs, and a second identical one captures
    nothing and gives the same bits."""
    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.solve import lm

    fn = solver_cases[name]
    with graphs.eager():
        lm.reset_loop_counts()
        want = fn()
        iters = lm.loop_counts()["iters"]
    lm.reset_loop_counts()
    got = fn()
    assert lm.loop_counts()["iters"] == iters and iters > 0
    core.reset_counts()
    again = fn()
    counts = core.counts()
    assert counts["captures"] == 0 and counts["replays"] > 0, counts
    assert _same_solver_bits(got, want) and _same_solver_bits(again, want)


@pytest.mark.cuda
def test_solver_chunk_makes_no_synchronizing_call(card, solver_cases):
    """A captured chunk of ``ba_solve``'s loop replays under
    ``set_sync_debug_mode("error")``, and so does the chunk's body run
    eagerly on the graph's buffers; a blocking ``.item()`` after them
    raises (the control)."""
    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.solve import lm

    solver_cases["ba_solve"]()
    chunk = next(g for k, g in core._cache.items() if k[0] is lm._ba_chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk.replay()
        lm._ba_chunk(*chunk.args, *chunk.inputs)
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.ones(1, device=card).item()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_two_threads_solve_one_shape_at_once(card):
    """Two threads solve problems of one shape at the same time, six times
    each (a barrier starts every pair of solves together): each result
    equals its eager solve bit for bit, and the overlap took a second
    instance of the loop's graphs (``graphs.lease``)."""
    import threading

    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.solve import lm

    core.reset()
    problems = []
    for seed in (6, 7):
        board, batch, poses = _calib_problem(96, seed, "cpu")
        problems.append(_ba_args(batch, poses, board, "cuda", scale=1.0 + seed / 500))
    with graphs.eager():
        wants = [lm.ba_solve(project_eucm, *a) for a in problems]
    start, errors = threading.Barrier(2), []

    def solve(i):
        try:
            for _ in range(6):
                start.wait(timeout=120)
                res = lm.ba_solve(project_eucm, *problems[i])
                if not _same_solver_bits(res, wants[i]):
                    errors.append(f"thread {i}: result differs from eager")
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=solve, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert any(k[0] is lm._ba_chunk and k[3] == 1 for k in core._cache)


@pytest.mark.cuda
def test_solver_capture_beside_device_synchronize(card):
    """A first solve (its captures) on one thread while this thread
    synchronizes the whole device in a loop through ``graphs.synchronize``
    (``bench_torch.py``'s route): no error on either side, the synchronize
    waits while a capture runs, and the solve equals eager."""
    import threading

    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.solve import lm

    board, batch, poses = _calib_problem(96, 8, "cpu")
    args = _ba_args(batch, poses, board, "cuda")
    with graphs.eager():
        want = lm.ba_solve(project_eucm, *args)
    core.reset()
    core.reset_counts()
    out, errors = [], []

    def solve():
        try:
            out.append(lm.ba_solve(project_eucm, *args))
        except Exception as e:  # reported below
            errors.append(repr(e))

    th = threading.Thread(target=solve)
    th.start()
    syncs = 0
    while th.is_alive():
        core.synchronize(card)
        syncs += 1
    th.join()
    assert not errors and syncs > 0 and core.counts()["captures"] > 0, errors
    assert _same_solver_bits(out[0], want)


@pytest.mark.cuda
def test_calibration_warmup_captures_nothing_beside_device_syncs(card):
    """``prewarm_calibration`` on a thread of its own while this thread
    synchronizes the whole device in a loop (``torch.cuda.synchronize``,
    as ``bench_torch.py``'s render does beside its warm-up): no error on
    either side, and no capture (the warm-up's ``no_capture`` scope)."""
    import threading

    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.calib.prewarm import prewarm_calibration

    core.reset()
    core.reset_counts()
    errors = []

    def warm():
        try:
            prewarm_calibration(create_default_6x6_board(), 64, "eucm", speculative=True,
                                device=card)
        except Exception as e:  # reported below
            errors.append(repr(e))

    th = threading.Thread(target=warm)
    th.start()
    while th.is_alive():
        torch.cuda.synchronize()
    th.join()
    assert not errors, errors
    counts = core.counts()
    assert counts["captures"] == 0 and counts["graphs"] == 0, counts


@pytest.mark.cuda
def test_solver_graphs_of_many_shapes_stay_bounded(card):
    """``ba_solve`` on ``SHAPES_KEPT`` + 4 shapes in turn (one board corner
    fewer each): the cache holds the start and chunk graphs of the
    ``SHAPES_KEPT`` shapes solved last and no more; the shape solved last
    replays, the one solved first is captured again; every result equals
    its eager solve bit for bit; and the dropped graphs' pools return to
    the card: after ``empty_cache`` its reserved memory grew by less than
    two shapes' pools over what it held after the first ``SHAPES_KEPT``
    shapes (four shapes' pools if nothing had returned)."""
    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.solve import lm

    n = core.SHAPES_KEPT
    board, batch, poses = _calib_problem(32, 9, "cpu")
    full = _ba_args(batch, poses, board, "cuda")
    problems = []
    for i in range(n + 4):
        keep = board.n_corners - i
        cut = (full[2][:keep], full[3][:, :keep], full[4][:, :keep])
        problems.append(full[:2] + tuple(t.contiguous() for t in cut) + full[5:])
    with graphs.eager():
        wants = [lm.ba_solve(project_eucm, *a) for a in problems]

    def ba_graphs():
        return [g for k, g in core._cache.items() if k[0] in (lm._ba_chunk, lm._ba_start)]

    core.reset()
    torch.cuda.empty_cache()
    reserved = []
    for i, args in enumerate(problems):
        assert _same_solver_bits(lm.ba_solve(project_eucm, *args), wants[i]), i
        assert len(ba_graphs()) == 2 * min(i + 1, n)
        if i + 1 in (n, n + 4):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(card))
    per_shape = sum(g.pool_bytes for g in ba_graphs()) / n
    assert per_shape > 0 and reserved[1] - reserved[0] < 2 * per_shape, (reserved, per_shape)
    for i, captures in ((n + 3, 0), (0, 2)):
        core.reset_counts()
        assert _same_solver_bits(lm.ba_solve(project_eucm, *problems[i]), wants[i])
        assert core.counts()["captures"] == captures, i
    core.reset()


# --------------------------------------------------------------------------
# the frame-sharded LM's per-shard graphs
# --------------------------------------------------------------------------


def _shard_mesh(card, cards):
    """Two shards of the card, or every visible card (skip below two)."""
    if cards == "one card":
        return [card, card]
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more visible cards")
    return [torch.device("cuda", i) for i in range(n)]


def _shard_solve(name):
    """name -> solve over a mesh: the single camera through
    ``make_ba_solver`` (64 frames, 0.3 px noise), the joint BA through
    ``multi_ba_sharded`` and ``multi_ba_sharded_mixed`` (3 cameras x 42
    frames of ``testdata.rig_problem``: the padding path on 4 and 8
    cards)."""
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.parallel import mesh
    from ccrs_tpu_torch.testdata import rig_problem

    if name == "make_ba_solver":
        board, batch, poses = _calib_problem(64, 5, "cpu")
        args = _ba_args(batch, poses, board, "cuda")
        return lambda m: mesh.make_ba_solver(project_eucm, m)(*args)
    rig = rig_problem(3, 42, seed=1, device="cuda")["args"]
    fn = getattr(mesh, name)
    return lambda m: fn(project_eucm, *rig, mesh=m)


def _result_bytes(res):
    """Every number of a BAResult / MultiBAResult, iterations included."""
    return [x.cpu().numpy().tobytes() if isinstance(x, torch.Tensor) else x for x in res]


def _per_shard(solve, m, cards):
    """``solve(m)`` on the per-shard route: forced on one card, the
    default over several."""
    from ccrs_tpu_torch.solve import lm

    with lm.shard_graphs(cards == "one card"):
        return solve(m)


SHARD_SOLVES = ("make_ba_solver", "multi_ba_sharded", "multi_ba_sharded_mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["one card", "every card"])
@pytest.mark.parametrize("name", SHARD_SOLVES)
def test_per_shard_graphs_equal_the_eager_sharded_route(card, name, cards):
    """The per-shard route (one graph per device and phase, the copies
    between them, one host read per chunk) against the eager sharded
    route (``graphs.eager()``) on the same mesh: theta, extrinsics, poses,
    cost and iterations equal bit for bit; every solve ran on the
    per-shard route, reading the stop flag once per chunk; a second solve
    of the same shape captures nothing and gives the same bits."""
    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.solve import lm

    m = _shard_mesh(card, cards)
    solve = _shard_solve(name)
    with graphs.eager():
        lm.reset_loop_counts()
        want = solve(m)
        eager = lm.loop_counts()
    lm.reset_loop_counts()
    got = _per_shard(solve, m, cards)
    counts = lm.loop_counts()
    core.reset_counts()
    again = _per_shard(solve, m, cards)
    second = core.counts()
    assert eager["routes"]["eager"] == counts["routes"]["shards"] == counts["solves"] > 0
    assert counts["iters"] == eager["iters"]
    assert counts["chunks"] * lm.CHUNK_ITERS - counts["masked"] == counts["iters"]
    assert second["captures"] == 0 and second["replays"] > 0, second
    assert _result_bytes(got) == _result_bytes(want) == _result_bytes(again)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["one card", "every card"])
def test_per_shard_copies_wait_for_delayed_sources(card, cards, monkeypatch):
    """Every graph replay of the per-shard route queued behind a sleep
    kernel on its device's stream (about 10 ms), so that each copy's
    source lands long after the host queued the copy and the receiving
    phase: the joint solve still equals the eager sharded route bit for
    bit.  A phase that read its receive buffer before the copy landed
    would read the previous iteration's values.  (Over two shards of one
    card every phase and copy shares one stream; over several cards the
    copies order the source's and the receiver's streams.)"""
    from ccrs_tpu_torch import graphs as core

    m = _shard_mesh(card, cards)
    solve = _shard_solve("multi_ba_sharded")
    with graphs.eager():
        want = solve(m)
    _per_shard(solve, m, cards)  # captured
    real = core.Graph.replay

    def delayed(self):
        with torch.cuda.device((self.inputs or self.bound)[0].device):
            torch.cuda._sleep(20_000_000)
        return real(self)

    monkeypatch.setattr(core.Graph, "replay", delayed)
    got = _per_shard(solve, m, cards)
    assert _result_bytes(got) == _result_bytes(want)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["one card", "every card"])
def test_per_shard_graphs_stay_bounded_per_card(card, cards):
    """The per-shard route on ``SHAPES_KEPT`` + 2 shapes in turn (one
    board corner fewer each): each card holds the shard phases' graphs of
    the ``SHAPES_KEPT`` shapes solved last and no more, and the first
    device's four phase graphs once (their buffers do not depend on the
    corner count, so every shape shares them); the shape solved last
    replays without a capture, the one solved first captures its shard
    graphs again; every result equals its eager solve bit for bit."""
    from ccrs_tpu_torch import graphs as core
    from ccrs_tpu_torch.models.projections import project_eucm
    from ccrs_tpu_torch.parallel import mesh
    from ccrs_tpu_torch.solve import lm

    m = _shard_mesh(card, cards)
    n = core.SHAPES_KEPT
    board, batch, poses = _calib_problem(8 * len(m), 9, "cpu")
    full = _ba_args(batch, poses, board, "cuda")
    problems = []
    for i in range(n + 2):
        keep = board.n_corners - i
        cut = (full[2][:keep], full[3][:, :keep], full[4][:, :keep])
        problems.append(full[:2] + tuple(t.contiguous() for t in cut) + full[5:])
    solve = mesh.make_ba_solver(project_eucm, m)
    with graphs.eager():
        wants = [solve(*a) for a in problems]
    ph = lm._BA_PHASES
    shard_phases, first_phases = {ph.system, ph.trial, ph.cost0}, {ph.solve, ph.update,
                                                                  ph.start, ph.scalars}
    devices = [torch.empty(0, device=d).device for d in m]

    def held(phases):
        per = {}
        for k in core._cache:
            if k[0] in phases:
                per[k[2]] = per.get(k[2], 0) + 1
        return per

    core.reset()
    for i, args in enumerate(problems):
        got = _per_shard(lambda _: solve(*args), m, cards)
        assert _result_bytes(got) == _result_bytes(wants[i]), i
        want = {}
        for d in devices:
            want[d] = want.get(d, 0) + 3 * min(i + 1, n)
        assert held(shard_phases) == want, i
        assert held(first_phases) == {devices[0]: 4}, i
    for i, captures in ((n + 1, 0), (0, 3 * len(m))):
        core.reset_counts()
        got = _per_shard(lambda _: solve(*problems[i]), m, cards)
        assert _result_bytes(got) == _result_bytes(wants[i])
        assert core.counts()["captures"] == captures, i
    core.reset()
