"""The port's pipelined cold detector against the JAX package's.

The same uint8 arrays (8 frames of 512x512, rendered from a seed, with
tags that only the board-assisted pass recovers) go through
``ccrs_tpu.detect.TagDetector`` and ``ccrs_tpu_torch.detect.TagDetector``
under the same ``CCRS_*`` knobs: ids exact, corners within 1e-3 px
(float32 sampling and 12 Newton steps, summed in another order).  Against
the port itself, the pipeline must give the bits that detecting each of
its chunks in a call of its own gives.  Also the chunk plan, the stage
timers, the loader's ``CCRS_DETECT_BATCH`` and ``adaptive_threshold_packed``.
"""

import gc
import os
import subprocess
import sys
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccrs_tpu.utils.profiling as jax_profiling
from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import detector as JD
from ccrs_tpu.detect import threshold as JT
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect import detector as TD
from ccrs_tpu_torch.detect import threshold as TT
from ccrs_tpu_torch.interop import board_from_ref
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses
from ccrs_tpu_torch.utils import profiling
from torch_jax_pin import assert_same_detections, fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: frame indices as a tracking audit passes them: a subset, out of order
AUDIT_IDX = [5, 0, 7, 3, 2, 6]


@pytest.fixture(scope="module")
def frames():
    """8 frames of a smooth 512x512 sequence with sensor noise, uint8; the
    board-assisted pass recovers tags in them (checked where it matters)."""
    board = jax_board()
    gt = GenericModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(64, board_from_ref(board), seed=5)[::8]
    return render_frames_device(
        gt, board_from_ref(board), get_family("t36h11"), poses, noise=1.5,
        generator=torch.Generator().manual_seed(5), device="cpu",
    ).numpy()


def create_board():
    return board_from_ref(jax_board())


def _exact(got, want):
    """Same ids per frame and bit-equal corners."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            np.testing.assert_array_equal(g[t], w[t])


@pytest.fixture
def recovered(monkeypatch):
    """Tags the port's assist merge recovers, per call of the merge."""
    seen = []
    real = TD.assist_merge
    monkeypatch.setattr(TD, "assist_merge", lambda *a: seen.append(real(*a)) or seen[-1])
    return seen


@pytest.mark.parametrize("order", ["contiguous", "audit_idx"])
def test_multi_chunk_cold_detection_matches_jax(frames, order, monkeypatch, recovered):
    """Four chunks of two frames (``CCRS_DETECT_CHUNK=2`` in both packages),
    with board-assisted recovery at work; ``audit_idx`` passes a subset of
    frame indices out of order, as the tracking audits do."""
    monkeypatch.setenv("CCRS_DETECT_CHUNK", "2")
    jdet = JaxDetector("t36h11", track=False)
    det = TagDetector("t36h11", track=False, device="cpu")
    assert jdet.chunk == det.chunk == 2
    jb = jax_board()
    if order == "contiguous":
        want = jdet.detect_batch(frames, board=jb)
        got = det.detect_batch(frames, board=board_from_ref(jb))
    else:
        want = jdet._detect_batch_cold(jnp.asarray(frames), jb, idx=np.asarray(AUDIT_IDX))
        got = det._detect_batch_cold(
            torch.from_numpy(frames), board_from_ref(jb), idx=np.asarray(AUDIT_IDX)
        )
    assert_same_detections(got, want, CORNER_TOL)
    assert min(len(g) for g in got) >= 25
    n_chunks = -(-len(got) // 2)
    assert len(recovered) >= 2 and sum(recovered) > 0, "no assist work in these frames"
    assert len(recovered) <= n_chunks


@pytest.mark.parametrize("order", ["contiguous", "audit_idx"])
def test_pipeline_equals_each_chunk_in_a_call_of_its_own(frames, order, monkeypatch):
    """The three-phase pipeline over four chunks gives the bits that the
    same chunk boundaries give one chunk per call (no overlap)."""
    monkeypatch.setenv("CCRS_DETECT_CHUNK", "2")
    board = create_board()
    det = TagDetector("t36h11", track=False, device="cpu")
    dev_all = torch.from_numpy(frames)
    idx = np.arange(len(frames)) if order == "contiguous" else np.asarray(AUDIT_IDX)
    got = det._detect_batch_cold(dev_all, board, idx=None if order == "contiguous" else idx)
    want = []
    for lo in range(0, len(idx), 2):
        want += det._detect_batch_cold(dev_all[idx[lo : lo + 2]].contiguous(), board)
    _exact(got, want)


@pytest.mark.parametrize("cpu", [True, False], ids=["cpu", "card"])
@pytest.mark.parametrize("forced", [None, 3, 8])
def test_chunk_plan_matches_jax(cpu, forced):
    for B in (0, 1, 2, 5, 7, 8, 21, 22, 63, 64, 65, 102, 130, 534):
        for chunk in (2, 4, 64):
            for small in (1, 2, 8, 100):
                want = JD._chunk_plan(B, chunk, small, cpu, forced)
                assert TD._chunk_plan(B, chunk, small, cpu, forced) == want, (B, chunk, small)
                # the detector's spans: the same pieces, the last one clipped
                spans = TD._chunk_spans(B, chunk, small, cpu, forced)
                assert [n for _, n in spans[:-1]] == want[:-1]
                assert [lo for lo, _ in spans] == list(np.cumsum([0] + want)[: len(want)])
                assert sum(n for _, n in spans) == B


@pytest.fixture
def chunk_sizes(monkeypatch):
    """The frame count of every threshold_front call of the port's detector."""
    sizes = []
    real = TD.threshold_front
    monkeypatch.setattr(
        TD, "threshold_front", lambda part, scale: sizes.append(part.shape[0]) or real(part, scale)
    )
    return sizes


def test_card_plan_on_the_cpu_matches_the_natural_plan(frames, monkeypatch, chunk_sizes):
    """``CCRS_FORCE_CHUNK_PLAN=1`` runs the JAX accelerator plan (the
    port's default is the natural plan on every device): with ``chunk=4``
    and ``cold_chunk=2``, 5 frames run as 4 + 1 (the plan's 4 + 2 clipped:
    no padding frame), against the natural 4 + 1 with ``chunk=4`` and the
    single natural chunk of 5.  Measured: ids equal and corners bit-equal (largest difference 0 px
    on this CPU); the tolerance is the stated 1e-3 px."""
    board = create_board()
    want = TagDetector("t36h11", track=False, device="cpu").detect_batch(frames[:5], board)
    assert chunk_sizes == [5]
    chunk_sizes.clear()
    monkeypatch.setenv("CCRS_FORCE_CHUNK_PLAN", "1")
    det = TagDetector("t36h11", track=False, device="cpu")
    det.chunk, det.cold_chunk = 4, 2
    assert det._spans(6) == [(0, 4), (4, 2)] and det._spans(7) == [(0, 4), (4, 2), (6, 1)]
    got = det.detect_batch(frames[:5], board)
    assert chunk_sizes == [4, 1]
    assert_same_detections(got, want, CORNER_TOL)


@pytest.mark.parametrize("env", [{}, {"CCRS_DETECT_CHUNK": "4", "CCRS_TRACK_COLD_CHUNK": "2"}],
                         ids=["defaults", "set"])
def test_default_plan_is_natural_on_every_device(env, monkeypatch):
    """Eagerly, unless ``CCRS_FORCE_CHUNK_PLAN`` is set, chunks take their
    natural size whatever the device (the JAX package's accelerator plan
    only bounds its compiled shapes); ``cold_chunk`` acts under the knob
    only.  With graphs (the card's default) the card takes the JAX
    accelerator plan, its last piece clipped and decoded at its full
    size."""
    from ccrs_tpu_torch.detect import graphs

    monkeypatch.delenv("CCRS_FORCE_CHUNK_PLAN", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for device in ("cpu", "cuda"):  # the plan reads no tensor: no card needed
        det = TagDetector("t36h11", track=False, device=device)
        with graphs.eager():
            for B in (0, 1, 5, 22, 63, 64, 65, 534):
                want = JD._chunk_plan(B, det.chunk, det.cold_chunk, cpu=True)
                spans = det._spans(B)
                assert [n for _, n in spans] == want, (device, B)
                assert [lo for lo, _ in spans] == list(np.cumsum([0] + want)[: len(want)])
                assert det._plan(B) == [(lo, n, n) for lo, n in spans]
            assert [n for _, n in det._spans(534, chunk=100)] == [100] * 5 + [34]
    det = TagDetector("t36h11", track=False, device="cuda")
    assert not graphs.active("cpu") and graphs.active(det.device)
    for B in (0, 1, 5, 22, 63, 64, 65, 534):
        want = JD._chunk_plan(B, det.chunk, det.cold_chunk, cpu=False)
        plan = det._plan(B)
        assert [C for _, _, C in plan] == want, B
        assert [lo for lo, _, _ in plan] == list(np.cumsum([0] + want)[: len(want)])
        assert [n for _, n, _ in plan] == want[:-1] + [B - sum(want[:-1])] * bool(want)


def test_pipeline_keeps_at_most_two_chunks_of_maps(frames, monkeypatch):
    """Phase 2 runs one chunk behind phase 1: when a chunk's refine+decode
    is queued, the KLT maps of at most one earlier chunk are still
    referenced, whatever the number of chunks (8 here)."""
    monkeypatch.setenv("CCRS_DETECT_CHUNK", "1")
    alive, seen = [], []
    real = TD.refine_decode_fused_dense

    def tracked_decode(*args, **kwargs):
        if kwargs.get("maps") is None:  # a primary decode, not the assist
            gc.collect()
            seen.append(sum(r() is not None for r in alive))
        out = real(*args, **kwargs)
        if kwargs.get("maps") is None:
            alive.append(weakref.ref(out["maps"]))
        return out

    monkeypatch.setattr(TD, "refine_decode_fused_dense", tracked_decode)
    det = TagDetector("t36h11", track=False, device="cpu")
    det.detect_batch(frames, create_board())
    assert len(seen) == len(frames) and seen[:2] == [0, 1]
    assert max(seen) == 1, seen


def test_pyramid_min_side_matches_jax(frames, monkeypatch):
    """``CCRS_PYRAMID_MIN_SIDE=512`` puts 512x512 frames on the
    half-resolution candidate path (scale 2) in both packages, which
    changes the detections: ids exact, corners within 1e-3 px."""
    monkeypatch.setenv("CCRS_PYRAMID_MIN_SIDE", "512")
    scales = []
    real = TD.threshold_front
    monkeypatch.setattr(
        TD, "threshold_front", lambda part, scale: scales.append(scale) or real(part, scale)
    )
    jdet = JaxDetector("t36h11", track=False)
    det = TagDetector("t36h11", track=False, device="cpu")
    assert jdet.pyramid_min_side == det.pyramid_min_side == 512
    jb = jax_board()
    want = jdet.detect_batch(frames[:4], board=jb)
    got = det.detect_batch(frames[:4], board=board_from_ref(jb))
    assert scales == [2]
    assert_same_detections(got, want, CORNER_TOL)
    # ~40 px tags are ~20 px at half resolution: most fall below the
    # candidate stage's reach, which is what the knob changes
    assert sum(len(g) for g in got) >= 10


def test_stage_names_match_jax(frames, monkeypatch, recovered):
    """With profiling on, the port's cold detector records the stage names
    the JAX detector records on the same input (assist work included)."""
    monkeypatch.setenv("CCRS_DETECT_CHUNK", "2")
    monkeypatch.setattr(jax_profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_ENABLED", True)
    jb = jax_board()
    jax_profiling.reset()
    JaxDetector("t36h11", track=False).detect_batch(frames[:4], board=jb)
    want = set(jax_profiling.totals())
    jax_profiling.reset()
    profiling.reset()
    TagDetector("t36h11", track=False, device="cpu").detect_batch(frames[:4], board_from_ref(jb))
    got = set(profiling.totals())
    profiling.reset()
    assert sum(recovered) > 0
    assert got == want == {
        "detect/threshold", "detect/quadproc", "detect/dispatch", "detect/decode", "detect/assist"
    }


@pytest.mark.parametrize("env", [{}, {"CCRS_DETECT_CHUNK": "16", "CCRS_PYRAMID_MIN_SIDE": "600",
                                      "CCRS_TRACK_COLD_CHUNK": "4"}], ids=["defaults", "set"])
def test_detector_knobs_match_jax(env, monkeypatch):
    for k in ("CCRS_DETECT_CHUNK", "CCRS_PYRAMID_MIN_SIDE", "CCRS_TRACK_COLD_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jdet = JaxDetector("t36h11")
    det = TagDetector("t36h11", device="cpu")
    for name in ("chunk", "pyramid_min_side", "cold_chunk"):
        assert getattr(det, name) == getattr(jdet, name), name


@pytest.mark.parametrize("value", [None, "37"])
def test_loader_reads_detect_batch_at_import(value):
    """``CCRS_DETECT_BATCH`` sets the loader's chunk, read at import (in a
    fresh process); unset, it is the JAX package's 192."""
    env = {k: v for k, v in os.environ.items() if k != "CCRS_DETECT_BATCH"}
    if value is not None:
        env["CCRS_DETECT_BATCH"] = value
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", "import ccrs_tpu_torch.dataloader as d; print(d.DETECT_BATCH)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120, check=True,
    )
    assert int(out.stdout.split()[-1]) == int(value or 192)


@pytest.mark.parametrize("separate", [True, False])
def test_adaptive_threshold_packed_matches_jax(frames, separate):
    rng = np.random.default_rng(2)
    for imgs in (frames[:2, :128, :256], rng.integers(0, 256, (3, 64, 96), np.uint8)):
        imgs = np.ascontiguousarray(imgs)
        for x in (imgs, imgs.astype(np.float32)):
            want = np.asarray(JT.adaptive_threshold_packed(jnp.asarray(x), separate=separate))
            got = TT.adaptive_threshold_packed(torch.from_numpy(x), separate=separate)
            assert got.dtype == torch.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)


def test_host_copies_on_the_cpu():
    """The pipeline's copy helpers on CPU tensors: the plain copy, values
    unchanged."""
    src = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    f = TD._Fetch(src)
    assert f.event is None
    np.testing.assert_array_equal(f.get(), src.numpy())
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]  # not contiguous
    t = TD._to_device(arr, torch.device("cpu"))
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), arr)
    got = TD._read_all(TD._fetch_all({"a": src, "b": src * 2}, ("b",)))
    assert list(got) == ["b"]
    np.testing.assert_array_equal(got["b"], src.numpy() * 2)
