"""The port's tracked detector on its own, on the CPU: the recall
guarantees and streaming behaviour of tests/test_track.py, run on
``ccrs_tpu_torch``.

- recall: tracked detections are a superset of the cold ones per frame on
  the 14-frame video; on the 48-frame bench-like video no tag the cold path
  finds is missing for more than the known-bad TTL plus the repair window,
  at most 5% of the cold (frame, tag) pairs are missed and the tracked
  total is at least the cold total;
- the fast path carries the load (few cold frames, few audits);
- a shuffled sequence falls back to cold; the carry spans calls;
- ``TrackedSession``: chunked feeds against one whole batch, the
  preallocated buffer against concatenation, tail padding kept out of the
  carry, too-short tails, and the provisional hook firing at most once,
  with every frame, only when an audit round exists; a raising hook is
  recorded in ``stats``; ``debug`` follows ``CCRS_TRACK_DEBUG``.
"""

import numpy as np
import pytest
import torch

from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect import audit as audit_mod
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def _render(n, seed, noise, **pose_kw):
    board = create_default_6x6_board()
    poses = smooth_sequence_poses(n, board, seed=seed, **pose_kw)
    return render_frames_device(
        GenericModel("eucm", GT, 512, 512), board, get_family("t36h11"), poses,
        noise=noise, generator=torch.Generator().manual_seed(seed),
        device="cpu",
    )


@pytest.fixture(scope="module")
def board():
    return create_default_6x6_board()


@pytest.fixture(scope="module")
def video():
    """14 noisy frames: the audits run."""
    return _render(14, 3, 1.5, keyframe_every=6)


@pytest.fixture(scope="module")
def bench_like():
    return _render(48, 11, 1.5)


@pytest.fixture(scope="module")
def whole(bench_like, board):
    det = TagDetector("t36h11", device="cpu")
    return det.detect_batch(None, board, dev_images=bench_like), det.stats


def _tracked(frames, board, det=None):
    det = det or TagDetector("t36h11", track=True, device="cpu")
    return det.detect_batch(None, board, dev_images=frames), det


def _cold(frames, board):
    return TagDetector("t36h11", track=False, device="cpu").detect_batch(None, board, dev_images=frames)


def test_track_recall_superset(video, board):
    cold = _cold(video, board)
    trk, det = _tracked(video, board)
    assert det.stats["trigger_frames"] > 0
    for f, (c, t) in enumerate(zip(cold, trk)):
        assert not set(c) - set(t), f"frame {f}: tracking dropped {set(c) - set(t)}"
        for tid in c:
            np.testing.assert_allclose(t[tid], c[tid], atol=0.2)


def test_track_bounded_staleness_and_fast_path(bench_like, board, whole):
    trk, stats = whole
    cold = _cold(bench_like, board)
    run_len: dict = {}
    worst = n_missed = n_cold = 0
    for c, t in zip(cold, trk):
        n_cold += len(c)
        m = set(c) - set(t)
        n_missed += len(m)
        for tid in list(run_len):
            if tid not in m:
                run_len.pop(tid)
        for tid in m:
            run_len[tid] = run_len.get(tid, 0) + 1
            worst = max(worst, run_len[tid])
    assert worst <= TagDetector("t36h11", device="cpu").cold_every + 4
    assert n_missed <= 0.05 * n_cold, (n_missed, n_cold)
    assert sum(len(t) for t in trk) >= n_cold
    assert stats["cold_frames"] <= len(trk) // 3 and stats["trigger_frames"] <= 8, stats
    assert all(len(r) >= 20 for r in trk)


def test_track_discontinuous_falls_back(video, board):
    shuffled = video[[5, 0, 9, 2, 12, 7]]
    cold = _cold(shuffled, board)
    trk, _ = _tracked(shuffled, board)
    for f, (c, t) in enumerate(zip(cold, trk)):
        assert set(c) <= set(t), f"frame {f}: lost {set(c) - set(t)}"


def test_track_carry_across_calls(bench_like, board, whole):
    det = TagDetector("t36h11", device="cpu")
    parts = _tracked(bench_like[:24], board, det)[0] + _tracked(bench_like[24:], board, det)[0]
    for f, (a, b) in enumerate(zip(whole[0], parts)):
        assert len(set(a) ^ set(b)) <= 2, f"frame {f}: {set(a) ^ set(b)}"
        for tid in set(a) & set(b):
            np.testing.assert_allclose(a[tid], b[tid], atol=0.2)


def _padded_tail(frames, start, pad):
    return torch.cat([frames[start:], frames[-1:].repeat(pad, 1, 1)])


def test_session_streaming_matches_whole_batch(bench_like, board, whole):
    det = TagDetector("t36h11", device="cpu")
    s = det.begin_tracked(board)
    s.feed(bench_like[:20])
    s.feed(bench_like[20:40])
    s.feed(_padded_tail(bench_like, 40, 12), n_valid=8)
    parts = s.finalize()
    assert len(parts) == 48
    n_whole = sum(len(r) for r in whole[0])
    assert abs(n_whole - sum(len(r) for r in parts)) <= 0.01 * n_whole
    for f, (a, b) in enumerate(zip(whole[0], parts)):
        assert len(set(a) ^ set(b)) <= 4, f"frame {f}: {set(a) ^ set(b)}"
        bad = sum(1 for tid in set(a) & set(b) if np.abs(a[tid] - b[tid]).max() > 0.25)
        assert bad <= 2, f"frame {f}: {bad} corner outliers"
    assert det.stats["frames"] == 60  # the padded count


def test_session_prealloc_buffer(bench_like, board):
    """With an n_frames hint feeds land in a preallocated buffer; the
    results equal the buffer-and-concatenate composition exactly."""
    tail = _padded_tail(bench_like, 40, 12)
    s = TagDetector("t36h11", device="cpu").begin_tracked(board, n_frames=48)
    s.feed(bench_like[:20])
    assert s._buf is not None and not s.chunks and s._buf.shape[0] == 60
    s.feed(bench_like[20:40])
    s.feed(tail, n_valid=8)
    res_hint = s.finalize()
    s2 = TagDetector("t36h11", device="cpu").begin_tracked(board)
    s2.feed(bench_like[:20])
    assert s2._buf is None and len(s2.chunks) == 1
    s2.feed(bench_like[20:40])
    s2.feed(tail, n_valid=8)
    res_concat = s2.finalize()
    assert len(res_hint) == len(res_concat) == 48
    for a, b in zip(res_hint, res_concat):
        assert set(a) == set(b)
        for tid in a:
            np.testing.assert_array_equal(a[tid], b[tid])
    with pytest.raises(RuntimeError):
        s2.finalize()


def test_session_padding_not_in_carry(bench_like, board):
    det = TagDetector("t36h11", device="cpu")
    s = det.begin_tracked(board)
    s.feed(_padded_tail(bench_like, 0, 12), n_valid=48)
    res = s.finalize()
    assert len(res) == 48
    st = det._tstate
    assert st["frame_idx"] == 48  # not the padded 60
    for carry_r, valid_r in zip(st["prev"], res[45:48]):
        assert set(carry_r) == set(valid_r)
        for tid in carry_r:
            np.testing.assert_array_equal(carry_r[tid], valid_r[tid])
    s2 = det.begin_tracked(board)
    s2.feed(bench_like[:5], n_valid=3)
    with pytest.raises(ValueError):
        s2.feed(bench_like[5:8])  # only the last feed may be padded


def test_session_short_chunks(video, board):
    cold = _cold(video, board)
    s = TagDetector("t36h11", device="cpu").begin_tracked(board)
    s.feed(video[:5])
    s.feed(video[5:11])
    s.feed(video[11:])  # 3 frames: below the tracking minimum
    res = s.finalize()
    assert len(res) == 14
    for f, (c, t) in enumerate(zip(cold, res)):
        assert not set(c) - set(t), f"frame {f}: session dropped {set(c) - set(t)}"


def test_session_provisional_fires_once_with_all_frames(video, board):
    det = TagDetector("t36h11", device="cpu")
    calls = []
    det.on_provisional = calls.append
    s = det.begin_tracked(board)
    s.feed(video[:7])
    s.feed(video[7:])
    final = s.finalize()
    assert det.stats["trigger_frames"] > 0
    assert len(calls) == 1 and len(calls[0]) == 14 and len(final) == 14
    assert sum(len(r) >= 20 for r in calls[0]) >= 10


def test_no_audits_no_speculation(video, board, monkeypatch):
    det = TagDetector("t36h11", device="cpu")
    fired = []
    det.on_provisional = lambda res: fired.append(len(res))
    det.detect_batch(None, board, dev_images=video)
    assert det.stats["trigger_frames"] > 0 and fired == [14]
    monkeypatch.setattr(audit_mod.AuditPolicy, "plan_round", lambda self, *a: None)
    det2 = TagDetector("t36h11", device="cpu")
    fired2 = []
    det2.on_provisional = lambda res: fired2.append(len(res))
    det2.detect_batch(None, board, dev_images=video)
    assert det2.stats["trigger_frames"] == 0
    assert fired2 == [], "hook fired with nothing to overlap"


def test_hook_error_is_recorded_and_debug_follows_env(video, board, monkeypatch):
    """A raising provisional hook does not stop detection and is recorded
    in stats; the debug stash exists only under CCRS_TRACK_DEBUG."""
    def boom(results):
        raise ValueError("hook failed")

    monkeypatch.setenv("CCRS_TRACK_DEBUG", "1")
    det = TagDetector("t36h11", device="cpu")
    det.on_provisional = boom
    res = det.detect_batch(None, board, dev_images=video)
    assert len(res) == 14
    assert "hook failed" in det.stats["provisional_error"]
    assert det.debug is not None and det.debug["g_acc"].shape == (14, board.n_tags)
    monkeypatch.delenv("CCRS_TRACK_DEBUG")
    det.on_provisional = None
    det.reset_tracking()
    det.detect_batch(None, board, dev_images=video[:8])
    assert det.debug is None and "provisional_error" not in det.stats
