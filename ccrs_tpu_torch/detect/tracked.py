"""Wave-tracking orchestration: the video fast path of the detector.

Port of ``ccrs_tpu/detect/tracked.py``.  This module lays out the anchor
triples and sweep rows, drives the wave step (track.wave_advance), and
runs the audit/repair loop whose decisions live in audit.AuditPolicy.  It
replaces the reference's unconditional per-frame detect loop
(``src/data_loader.rs:114-127``) for steady-state video, with the audit
policy anchoring recall to the cold path.

Streaming: ``TrackedSession.feed`` copies each chunk into a preallocated
whole-sequence tensor on the detector's device; ``finalize`` runs ONE
whole-batch tracked detection, so a chunked loader pays the anchor and
audit rounds once per sequence and the provisional hook fires once with
every frame.

Every decision (anchor layout, cold-direct segments, audits, resweeps)
is the JAX package's, so both packages detect the same tags on the same
frames.  The JAX package rounds the wave row count and the resweep wave
count up to fixed buckets so its compiled graphs are reused; eager torch
compiles nothing, so the port runs exactly the rows and waves it needs
(rows never interact, and inactive rows decode nothing).

Sharding (``TagDetector(shard=)``): ``finalize`` splits the whole sequence
over the mesh once.  Anchors, cold-direct and audit sweeps then run through
the sharded cold path, each shard's frames on its own device.  The waves
read neighbouring frames, which may lie on different shards, so they run
on the first shard's device: each wave gathers its rows' frames there.
Results equal the unsharded run's bit for bit.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.profiling import stage
from .audit import AuditPolicy, RowLayout
from .track import (
    MIN_TRACK_TAGS,
    carry_to_device,
    detections_to_arrays,
    init_wave_carry,
    wave_advance,
)

log = logging.getLogger(__name__)


class TrackedSession:
    """Streaming wave-tracked detection over a chunked frame sequence.

    Usage (the dataloader's streaming path)::

        session = detector.begin_tracked(board, n_frames=len(paths))
        for chunk in chunks:                  # (B, H, W) tensors, in order
            session.feed(chunk, n_valid)      # n_valid < B only on the tail
        results = session.finalize()          # audited, len == sum(n_valid)

    ``feed`` copies the chunk into a whole-sequence tensor preallocated on
    the detector's device (capacity ``n_frames`` rounded up to a multiple
    of the first chunk), so peak device memory is one sequence plus one
    chunk; without an ``n_frames`` hint the chunks are kept and
    concatenated once at ``finalize``.  Padding (repeats of the last
    frame, ``n_valid`` < B) may only come in the last feed.
    """

    def __init__(self, det, board, n_frames: Optional[int] = None):
        self.det = det
        self.board = board
        self.n_hint = n_frames
        self.chunks: List[torch.Tensor] = []
        self._buf: Optional[torch.Tensor] = None
        self.n_valid = 0   # caller-valid frames
        self.n_padded = 0  # fed frames incl. tail padding
        self._finalized = False

    def feed(self, dev_chunk, n_valid: Optional[int] = None) -> None:
        """Buffer the next (B, H, W) chunk of the sequence."""
        if self._finalized:
            raise RuntimeError("session already finalized")
        if self.n_valid != self.n_padded:
            raise ValueError("only the last feed may carry tail padding")
        dev_chunk = torch.as_tensor(dev_chunk)
        B = int(dev_chunk.shape[0])
        n_valid = B if n_valid is None else int(n_valid)
        if (
            self._buf is None and not self.chunks
            and self.n_hint is not None and self.n_hint > B
        ):
            cap = -(-self.n_hint // B) * B
            self._buf = torch.empty(
                (cap,) + tuple(dev_chunk.shape[1:]), dtype=dev_chunk.dtype,
                device=dev_chunk.device,
            )
        if self._buf is not None:
            if (
                dev_chunk.dtype != self._buf.dtype
                or tuple(dev_chunk.shape[1:]) != tuple(self._buf.shape[1:])
            ):
                raise ValueError("chunks must be dtype/shape homogeneous")
            if self.n_padded + B > self._buf.shape[0]:
                # the hint undershot: grow by whole chunks
                grow = -(-(self.n_padded + B - self._buf.shape[0]) // B) * B
                self._buf = torch.cat([
                    self._buf,
                    self._buf.new_empty((grow,) + tuple(self._buf.shape[1:])),
                ])
            self._buf[self.n_padded : self.n_padded + B].copy_(dev_chunk)
        else:
            self.chunks.append(dev_chunk)
        self.n_valid += n_valid
        self.n_padded += B

    def finalize(self) -> List[Dict[int, np.ndarray]]:
        """Run the whole-batch tracked detection over the buffered
        sequence; returns per-frame results (tail padding dropped)."""
        if self._finalized:
            raise RuntimeError("session already finalized")
        self._finalized = True
        if self._buf is not None:
            dev_full = self._buf[: self.n_padded]
            self._buf = None
        elif not self.chunks:
            return []
        else:
            dev_full = self.chunks[0] if len(self.chunks) == 1 else torch.cat(self.chunks)
            self.chunks = []
        dev_full = self.det._shard_frames(dev_full)
        results = _detect_tracked(self.det, dev_full, self.board, n_valid=self.n_valid)
        return results[: self.n_valid]


def detect_batch_tracked(det, dev_all, board) -> List[Dict[int, np.ndarray]]:
    """Whole-batch wave tracking = a one-feed TrackedSession."""
    return _detect_tracked(det, dev_all, board, n_valid=dev_all.shape[0])


def _run_waves(det, dev_all, board_xy, first: int, frame_of, act, carry):
    """Advance the carry through ``len(frame_of)`` waves; wave w runs row r
    on frame ``frame_of[w, r]`` (active where ``act[w, r]``).  Returns the
    per-wave outputs stacked on the device: (corners, acc, att, benign),
    each with a leading (W, R) shape."""
    dev = dev_all.device
    frame_t = torch.as_tensor(frame_of.astype(np.int64), device=dev)
    act_t = torch.as_tensor(act, device=dev)
    outs = []
    for w in range(frame_of.shape[0]):
        imgs_w = dev_all.index_select(0, frame_t[w])
        carry, out = wave_advance(det.family, imgs_w, board_xy, first, carry, act_t[w])
        outs.append(out)
    return tuple(torch.stack(x) for x in zip(*outs))


def _detect_tracked(det, dev_all, board, n_valid: int):
    """Wave tracking over one (B, H, W) batch on its device.

    Cold-detect anchor TRIPLES every ``cold_every`` frames (a triple gives
    each anchor a velocity and an acceleration), then sweep every
    inter-anchor segment in waves: wave w advances all segments' forward
    sweeps (from the left triple) and backward sweeps (from the right
    triple) by one frame.

    Recall policy (audit.AuditPolicy):

    * anchors ARE cold frames every ``cold_every``;
    * a frame is SUSPECT when a tag with a valid in-bounds prediction
      hard-failed (not benign and not known-bad) or too few tags were
      accepted; suspects are cold-verified in batched sweeps and cold wins;
    * known_bad = tags whose hard failure a cold audit confirmed; their
      later failures don't re-trigger within the TTL.

    ``n_valid``: frames the caller considers real — trailing padding frames
    are detected but never audited, never reported to the provisional hook
    and never seed the carry.

    The carry persists across calls (the last three valid frames' results
    seed the next call's first segment), so consecutive ``detect_batch``
    calls keep tracking; ``reset_tracking()`` between unrelated sequences.
    """
    from .detector import _anchor_starts

    B, H, W = dev_all.shape
    K = max(det.cold_every, 4)
    n_tags = board.n_tags
    first = board.config.first_id

    st = det._tstate
    if st is None or st["wh"] != (W, H) or st["board"] is not board:
        st = det._tstate = {
            "wh": (W, H), "board": board,
            # results of the previous call's last three valid frames
            "prev": None,
            # tag -> global frame of the last cold confirmation that the
            # tag is undetectable
            "known_bad": {}, "frame_idx": 0,
        }
    det.stats = {"frames": B, "cold_frames": 0, "cold_groups": 0,
                 "trigger_frames": 0, "waves": 0}
    g0 = st["frame_idx"]

    def cold_sweep(frames: List[int], tag: str):
        """Cold-detect the given frame indices in one batched pass."""
        with stage(tag):
            res = det._detect_batch_cold(dev_all, board, idx=np.asarray(frames, np.int64))
        det.stats["cold_frames"] += len(frames)
        det.stats["cold_groups"] += 1
        return dict(zip(frames, res))

    if B < 4:
        # too short to track: cold only, but still feed the carry
        coldres = cold_sweep(list(range(B)), "detect/track-cold")
        results = [coldres[f] for f in range(B)]
        _advance_carry(st, results, n_valid)
        det.debug = None
        return results

    # ---- anchor triple layout (global cadence K) -------------------
    virtual = st["prev"] if (
        st["prev"] is not None and len(st["prev"][-1]) >= MIN_TRACK_TAGS
    ) else None
    gp = ((g0 + K - 1) // K) * K  # first grid anchor start >= g0
    p = gp - g0
    if virtual is None and p != 0:
        p = 0  # no carry: the batch head needs an anchor
    starts = _anchor_starts(B, K, p)

    anchor_frames = sorted({f for q in starts for f in (q, q + 1, q + 2)})
    coldres = cold_sweep(anchor_frames, "detect/track-cold")
    resmap: Dict[int, Dict[int, np.ndarray]] = dict(coldres)
    if virtual is not None:
        resmap[-3], resmap[-2], resmap[-1] = virtual

    all_starts = ([-3] if virtual is not None else []) + starts
    segs = list(zip(all_starts[:-1], all_starts[1:]))
    n_list = [pR - pL - 3 for pL, pR in segs]

    def anchor_count(p0: int) -> int:
        return max(len(resmap.get(p0 + k, {})) for k in range(3))

    # Sparse-board segments go COLD-DIRECT: when the bracketing anchors see
    # under sparse_frac of the board, homography extrapolation from a few
    # packed rim neighbours collapses, and the audits it would trigger
    # cost more than detecting the segment cold up front.
    sparse_thr = max(MIN_TRACK_TAGS + 2, int(det.sparse_frac * n_tags))
    cold_direct = {
        si for si, (pL, pR) in enumerate(segs)
        if min(anchor_count(pL), anchor_count(pR)) < sparse_thr
    }
    direct_frames = sorted(
        f
        for si in cold_direct
        for f in range(max(segs[si][0] + 3, 0), segs[si][1])
        if f not in coldres
    )
    Wmax = (
        max(((n + 1) // 2 for n in n_list), default=0)
        if len(cold_direct) < len(segs)
        else 0
    )

    g_cor = np.zeros((B, n_tags, 4, 2), np.float32)
    g_acc = np.zeros((B, n_tags), bool)
    g_att = np.zeros((B, n_tags), bool)
    g_ben = np.zeros((B, n_tags), bool)

    dev = dev_all.device
    board_xy = torch.as_tensor(
        board.p3d.reshape(n_tags, 4, 3)[:, :, :2].astype(np.float32), device=dev
    )

    def store(frame_of, act, stacked, rewrite=None) -> None:
        oc, ac, at, bn = (t.cpu().numpy() for t in stacked)
        for w in range(frame_of.shape[0]):
            rows = np.flatnonzero(act[w])
            f = frame_of[w, rows]
            g_cor[f] = oc[w, rows]
            g_acc[f] = ac[w, rows]
            g_att[f] = at[w, rows]
            g_ben[f] = bn[w, rows]
            if rewrite is not None:
                for ff in f:
                    rewrite(int(ff))

    def seed_carry(seeds, R: int):
        """Wave carry of R rows from (row, (res1, res2, res3)) seeds."""
        c1 = np.zeros((R, n_tags, 4, 2), np.float32)
        v1 = np.zeros((R, n_tags), bool)
        c2, v2 = c1.copy(), v1.copy()
        c3, v3 = c1.copy(), v1.copy()
        for r, (r1, r2, r3) in seeds:
            c1[r], v1[r] = detections_to_arrays(r1, board)
            c2[r], v2[r] = detections_to_arrays(r2, board)
            c3[r], v3[r] = detections_to_arrays(r3, board)
        return carry_to_device(init_wave_carry(c1, v1, c2, v2, c3, v3), dev)

    R = 2 * len(segs)
    if Wmax > 0:
        frame_of = np.zeros((Wmax, R), np.int64)
        act = np.zeros((Wmax, R), bool)
        seeds = []
        for si, ((pL, pR), n) in enumerate(zip(segs, n_list)):
            if si in cold_direct:
                continue
            fc = (n + 1) // 2  # the forward sweep takes the extra frame
            for w in range(fc):
                frame_of[w, 2 * si] = pL + 3 + w
                act[w, 2 * si] = True
            for w in range(n - fc):
                frame_of[w, 2 * si + 1] = pR - 1 - w
                act[w, 2 * si + 1] = True
            seeds.append((2 * si, (resmap[pL + 2], resmap[pL + 1], resmap[pL])))
            seeds.append((2 * si + 1, (resmap[pR], resmap[pR + 1], resmap[pR + 2])))
        with stage("detect/track"):
            # queued on the device; the cold-direct sweep's host work below
            # overlaps it, and the first download waits for it
            stacked = _run_waves(
                det, dev_all, board_xy, first, frame_of, act, seed_carry(seeds, R)
            )
        det.stats["waves"] = Wmax
        if direct_frames:
            coldres.update(cold_sweep(direct_frames, "detect/track-cold"))
        with stage("detect/track"):
            store(frame_of, act, stacked)
    elif direct_frames:
        coldres.update(cold_sweep(direct_frames, "detect/track-cold"))

    # row bookkeeping for the repair re-sweeps below
    layout = RowLayout.empty(B)
    if Wmax > 0:
        for r in range(R):
            fl = [int(frame_of[w, r]) for w in range(Wmax) if act[w, r]]
            if fl:
                layout.row_frames[r] = fl
                for w, f in enumerate(fl):
                    layout.row_of[f] = r
                    layout.pos_of[f] = w

    # per-segment expected tag count, from the bracketing cold anchors:
    # a frame of a partially visible board seeing that many tags is healthy
    seg_expect = {
        si: min(anchor_count(pL), anchor_count(pR)) for si, (pL, pR) in enumerate(segs)
    }

    # ---- results + post-hoc audit/repair loop ---------------------
    results: List[Dict[int, np.ndarray]] = [dict() for _ in range(B)]

    def write_result(f: int) -> None:
        tracked = {int(t) + first: g_cor[f, t].copy() for t in np.flatnonzero(g_acc[f])}
        if f in coldres:
            merged = dict(coldres[f])
            for t, cc in tracked.items():
                merged.setdefault(t, cc)
            results[f] = merged
        else:
            results[f] = tracked

    for f in range(B):
        write_result(f)

    # Provisional-results hook: detections are complete up to the audit
    # corrections from here on, so a caller's callback (the speculative
    # calibration) can overlap its solve with the audit sweeps.  It fires
    # only when an audit round exists: with nothing to overlap, a
    # speculation the caller joins would sit in front of the final solve.
    def fire_provisional() -> None:
        if det.on_provisional is None:
            return
        try:
            det.on_provisional([dict(r) for r in results[:n_valid]])
        except Exception as e:  # the hook must not break detection
            log.exception("on_provisional hook failed")
            det.stats["provisional_error"] = repr(e)

    def fails_at(f: int) -> set:
        return set(int(t) for t in np.flatnonzero(g_att[f] & ~g_acc[f] & ~g_ben[f]))

    policy = AuditPolicy(
        n_tags=n_tags, g0=g0, known_bad=st["known_bad"], kb_ttl=2 * K,
        layout=layout, seg_expect=seg_expect,
    )

    def res_at(f: int) -> Dict[int, np.ndarray]:
        return results[f] if f >= 0 else resmap.get(f, {})

    def run_resweeps(jobs) -> None:
        """Re-run sweep rows from corrected seeds.  jobs: list of
        (frames in sweep order, seed frames (f1 nearest, f2, f3))."""
        W2 = max(len(fl) for fl, _ in jobs)
        f_of = np.zeros((W2, len(jobs)), np.int64)
        a2 = np.zeros((W2, len(jobs)), bool)
        for j, (fl, _) in enumerate(jobs):
            f_of[: len(fl), j] = fl
            a2[: len(fl), j] = True
        seeds = [
            (j, (res_at(f1), res_at(f2), res_at(f3)))
            for j, (_, (f1, f2, f3)) in enumerate(jobs)
        ]
        with stage("detect/track"):
            stacked = _run_waves(
                det, dev_all, board_xy, first, f_of, a2, seed_carry(seeds, len(jobs))
            )
            store(f_of, a2, stacked, rewrite=write_result)

    # Audit/repair loop: rounds strictly grow the audited set, so it
    # terminates; tail-padding frames (>= n_valid) count as cold so they
    # are never audited.
    in_cold_pad = set(range(n_valid, B))
    first_round = True
    while True:
        fails_sets = [fails_at(f) for f in range(B)]
        acc_counts = g_acc.sum(axis=1)
        plan = policy.plan_round(fails_sets, acc_counts, set(coldres) | in_cold_pad)
        if first_round:
            first_round = False
            if plan is not None:
                # audits will run: start the speculation now
                fire_provisional()
        if plan is None:
            break
        lead = plan.lead
        det.stats["trigger_frames"] += len(lead)
        coldres.update(cold_sweep(lead, "detect/track-audit"))
        cold_tags = {f: {int(t) - first for t in coldres[f]} for f in lead}
        added = {f: any(t not in results[f] for t in coldres[f]) for f in lead}
        improved = policy.record_outcome(plan, fails_sets, cold_tags, added)
        for f in lead:
            write_result(f)
        jobs = policy.resweep_jobs(improved, plan.no_resweep)
        if jobs:
            det.stats["resweeps"] = det.stats.get("resweeps", 0) + len(jobs)
            run_resweeps(jobs)
    if policy.trigger_log:
        det.stats["trigger_log"] = policy.trigger_log
    # diagnostic stash (never read by the pipeline): per-(frame, tag) wave
    # outcomes and what cold saw; cleared when the variable is unset so a
    # stale stash never describes another batch
    if os.environ.get("CCRS_TRACK_DEBUG"):
        det.debug = {
            "g_acc": g_acc, "g_att": g_att, "g_ben": g_ben,
            "g_cor": g_cor, "coldres": dict(coldres),
            "layout": layout, "segs": segs, "cold_direct": cold_direct,
            "known_bad": dict(st["known_bad"]),
        }
    else:
        det.debug = None

    _advance_carry(st, results, n_valid)
    return results


def _advance_carry(st, results, n_valid: int) -> None:
    """Advance the streaming carry past this batch using only the
    caller-VALID frames: tail padding must neither seed the next call's
    triple nor shift the global frame counter of the known_bad stamps."""
    if n_valid >= 3:
        st["prev"] = (results[n_valid - 3], results[n_valid - 2], results[n_valid - 1])
    else:
        st["prev"] = None  # too short to re-seed a triple
    st["frame_idx"] += n_valid
