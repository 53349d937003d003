"""Audit policy for the wave-tracking fast path — the recall guarantee.

A copy of ``ccrs_tpu/detect/audit.py`` (pure numpy; the port keeps every
decision identical so both packages audit the same frames).

The wave tracker (track.py) replaces the cold pipeline for steady-state
video frames, so its recall is anchored to the cold detector's by this
policy: every tracking hard-failure must end the batch either benign
(cold-equivalent by construction), cold-audited on that very frame, or
cold-confirmed absent (the analogue of the reference's unconditional
per-frame detect, ``src/data_loader.rs:36-70``).

This module holds the pure decision logic — suspect classification,
lead-frame selection, known_bad bookkeeping, and resweep-repair job
construction — with no device or image dependencies, so its transitions
are directly unit-testable (tests/test_torch_audit.py).  The tracked
detector (tracked._detect_tracked) drives it: it computes per-frame
observations from the wave outputs, asks the policy what to audit, runs
the batched cold sweeps/re-sweeps, and reports the outcomes back.

Policy summary (measured tradeoffs are cited inline):

* A frame is SUSPECT when a tag with a valid in-bounds prediction
  hard-failed (not benign, not known-bad) or too few tags were accepted
  relative to what its segment's anchors see.
* HEAVY suspects (>=3 novel failures, or an acceptance count under the
  anchor expectation minus slack) can indicate a degraded carry: only the
  LEADING heavy suspect of each sweep row is audited, and when the audit
  recovers tags the rest of the row is RE-SWEPT from the corrected frame
  (one bad stretch must not turn its half-segment into per-frame audits).
  A lead with MASS failure excludes its row from resweep-repair (repair
  would just re-fail); the row's remaining suspects are NOT eagerly
  colded — they are re-planned in round 2, AFTER the lead's audit stamps
  known_bad for every confirmed absence, so the stamp suppression can
  shrink the set first (see the plan_round inline measurement).
* LIGHT suspects (1-2 flickering tags on an otherwise healthy frame) ride
  the same batched sweep but never trigger resweeps, and they wait until
  after round-1 repairs (a repaired carry clears most flickers for free;
  measured 81 -> 31 audited frames on the 534-frame bench).  All merged
  lights are audited — audit cost is sweep-count-dominated on this link,
  so trimming frames per sweep doesn't pay (see plan_round).
* known_bad = tags whose hard failure a cold audit CONFIRMED (occlusion,
  rim clipping); their later failures don't re-trigger for KB_TTL frames,
  so a persistent blind spot costs one audit per ~2 segments instead of
  one per frame — but re-confirms eventually (recall safety if the tag
  reappears where the predictor fails but cold would decode).
* Rounds strictly grow the audited set, so the loop terminates; round 2
  audits every remaining suspect with no further resweep (final round).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .track import MIN_TRACK_TAGS


@dataclass
class RowLayout:
    """Static sweep-row geometry of one tracked batch.

    row_of/pos_of: per-frame sweep row index and position within the row
    (-1 for frames outside any wave row, e.g. anchors and cold-direct
    segments); row_frames: frames of each row in sweep order.  Even rows
    sweep forward (frame index increasing), odd rows backward.
    """

    row_of: np.ndarray
    pos_of: np.ndarray
    row_frames: Dict[int, List[int]]

    @staticmethod
    def empty(B: int) -> "RowLayout":
        return RowLayout(
            np.full(B, -1, np.int32), np.full(B, -1, np.int32), {}
        )


@dataclass
class RoundPlan:
    """One audit round's decisions.

    lead: frames to cold-audit (one batched sweep), in trigger order;
    light_set: the subset that is light (excluded from resweep-repair);
    no_resweep: rows whose improvements must NOT trigger a resweep this
    round (mass-failure rows sent straight to cold, or — in the final
    round — every row).
    """

    lead: List[int]
    light_set: Set[int]
    no_resweep: Set[int]


@dataclass
class AuditPolicy:
    """The audit/repair state machine (see module docstring).

    Args:
      n_tags: board tag count.
      g0: global frame index of batch frame 0 (known_bad stamps are
        global so they survive across streaming detect_batch calls).
      known_bad: the persistent {local tag id: global frame of last cold
        confirmation} dict — OWNED by the caller's tracking state; this
        policy reads and stamps it in place.
      kb_ttl: frames a cold-confirmed absence suppresses re-audits
        (detector passes 2*K — the audit-cadence bound; see the KB_TTL
        discussion in the module docstring).
      layout: sweep-row geometry (RowLayout).
      seg_expect: per-segment expected tag count, min() over the two
        bracketing anchor triples — a frame seeing that many tags is
        healthy even when the count is far below n_tags (partially
        visible board).  Rows 2*si and 2*si+1 belong to segment si.
    """

    n_tags: int
    g0: int
    known_bad: Dict[int, int]
    kb_ttl: int
    layout: RowLayout
    seg_expect: Dict[int, int]
    rounds: int = 0
    trigger_log: List[Tuple[int, List[int]]] = field(default_factory=list)

    # ---------------------------------------------------------- queries
    def known_bad_at(self, f: int) -> Set[int]:
        """Tags whose cold-confirmed absence suppresses audits at batch
        frame ``f``.

        The test is one-sided, ``g - stamp <= kb_ttl`` with ``g = g0 + f``:
        a stamp suppresses every frame from ``kb_ttl`` frames after it
        back to the start of the sequence, so a confirmation at frame 500
        also silences the same tag's failures at frames 300..499.  This is
        the JAX package's semantics, kept on purpose: audit decisions (and
        so the detections) must be the same in both packages.  A frame
        before the stamp that the absence does not cover can only lose an
        audit of a tag the cold path confirmed missing nearby later; the
        anchors every ``cold_every`` frames still bound how long such a
        tag can stay missing.
        """
        g = self.g0 + f
        return {
            t for t, s in self.known_bad.items() if g - s <= self.kb_ttl
        }

    def expected_at(self, f: int) -> int:
        r = int(self.layout.row_of[f])
        if r < 0:
            return self.n_tags
        return self.seg_expect.get(r // 2, self.n_tags)

    def _novel(self, f: int, fails: Set[int]) -> Set[int]:
        return fails - self.known_bad_at(f)

    # ------------------------------------------------------------ classification
    def _classify(
        self,
        fails_sets: Sequence[Set[int]],
        acc_counts: np.ndarray,
        in_cold: Set[int],
    ) -> Tuple[List[int], List[int]]:
        """(heavy, light) suspect frames under the current observations."""
        B = len(fails_sets)
        heavy: List[int] = []
        for f in range(B):
            if f in in_cold:
                continue
            novel = self._novel(f, fails_sets[f])
            # slack 4: a frame 1-3 tags under the anchor expectation with
            # <3 novel hard failures is light, not heavy
            thr = max(
                MIN_TRACK_TAGS,
                min(self.n_tags // 2, self.expected_at(f) - 4),
            )
            if len(novel) >= 3 or int(acc_counts[f]) < thr:
                heavy.append(f)
        heavy_set = set(heavy)
        light = [
            f
            for f in range(B)
            if f not in in_cold
            and f not in heavy_set
            and self._novel(f, fails_sets[f])
        ]
        return heavy, light

    # ------------------------------------------------------------ rounds
    def plan_round(
        self,
        fails_sets: Sequence[Set[int]],
        acc_counts: np.ndarray,
        in_cold: Set[int],
    ) -> Optional[RoundPlan]:
        """Classify every frame and pick this round's audit set.

        fails_sets[f]: local tag ids that hard-failed on frame f
        (attempted & !accepted & !benign — the detector recomputes these
        after each resweep); acc_counts[f]: accepted tag count; in_cold:
        frames that already have cold results (never re-audited).

        Returns None when no suspects remain (the loop's exit).
        """
        heavy, light = self._classify(fails_sets, acc_counts, in_cold)
        if not heavy and not light:
            return None
        self.rounds += 1
        # LIGHT suspects join a sweep only AFTER the round-1 resweeps ran
        # (or when no heavy round is needed at all): a repaired carry
        # re-tracks downstream frames and clears most 1-2-tag flickers
        # for free (measured: sweeping lights before the resweep audited
        # 81 frames where waiting audits 31; re-measured with the
        # representative rule — merging lights into round 1 still LOST,
        # 54 -> 71 triggers and a third serial round, 1.57 -> 1.70 s).
        merge_light = (not heavy) or self.rounds > 1
        if self.rounds > 1:
            # The lead-per-row policy pays off only while re-sweeps
            # resolve downstream suspects wholesale; round 1 already
            # audited every then-current suspect, so whatever remains
            # came from its resweeps — audit it all in ONE batched
            # sweep, with no further resweep (guarantees this is the
            # final round).
            lead = list(heavy)
            # every known row (keys, not a dense range: a streaming
            # session's global row ids are bucket-aligned per chunk and
            # therefore non-contiguous), plus -1 for rowless frames
            no_resweep = set(self.layout.row_frames.keys()) | {-1}
        else:
            seen_rows: Set[int] = set()
            lead = []
            no_resweep = set()
            # the LEAD of a row is its earliest heavy suspect in SWEEP
            # order (min pos_of), not in frame order: odd rows sweep
            # backward, and picking the ascending-frame first suspect
            # there chose the sweep-TAIL frame — its resweep window
            # (row_frames[pos+1:]) was empty, so the repair mechanism
            # never fired for backward rows
            for f in sorted(heavy, key=lambda f: int(self.layout.pos_of[f])):
                r = int(self.layout.row_of[f])
                if r < 0:
                    lead.append(f)
                elif r not in seen_rows:
                    seen_rows.add(r)
                    lead.append(f)
                    novel_n = len(self._novel(f, fails_sets[f]))
                    row_thr = max(
                        MIN_TRACK_TAGS,
                        min(self.n_tags // 2, self.expected_at(f) - 2),
                    )
                    if (
                        novel_n >= self.n_tags // 4
                        or int(acc_counts[f]) < row_thr
                    ):
                        # MASS failure (an oblique/rim stretch where
                        # decode struggles): repair-and-resweep would
                        # just re-fail, so exclude the row from repair.
                        # Its downstream suspects are NOT eagerly colded
                        # here: the lead's audit stamps known_bad for
                        # every confirmed absence, and round 2 plans the
                        # remaining suspects AFTER those stamps land —
                        # eagerly extending the whole row (or even just
                        # its suspects) pre-empts that suppression
                        # cascade and audited 103-114 frames where the
                        # staged version audits ~74 (measured r04,
                        # 534-frame bench).
                        no_resweep.add(r)
        lead_set = set(lead)
        light_set: Set[int] = set()
        if merge_light:
            # ALL merged lights are audited in one sweep.  A one-
            # representative-per-(tag, TTL-window) rule was tried and
            # REVERTED: it cut audited frames 74 -> 54, but on this
            # link the audit cost is SWEEP-count-dominated (~0.2 s
            # fixed pipeline cost per batched sweep vs ~2.5 ms per
            # frame), and reps whose audit FOUND the tag forced a third
            # serial round for their windows — measured 1.43 s vs
            # 1.33 s best on the 534-frame bench (r04).  Auditing every
            # light also stamps known_bad for every confirmed absence,
            # which is strictly more suppression for streaming batches.
            extra = [f for f in light if f not in lead_set]
            lead.extend(extra)
            light_set = set(extra)
        for f in lead:
            self.trigger_log.append((f, sorted(self._novel(f, fails_sets[f]))))
        return RoundPlan(lead=lead, light_set=light_set, no_resweep=no_resweep)

    def record_outcome(
        self,
        plan: RoundPlan,
        fails_sets: Sequence[Set[int]],
        cold_tags: Dict[int, Set[int]],
        added: Dict[int, bool],
    ) -> List[int]:
        """Fold one round's cold-audit results back into the policy.

        cold_tags[f]: LOCAL tag ids the cold audit decoded on frame f;
        added[f]: whether the audit recovered any tag tracking had missed.
        Stamps known_bad for every hard-failure the audit CONFIRMED
        absent, and returns the frames eligible to seed a resweep
        (improved, non-light).
        """
        improved: List[int] = []
        for f in plan.lead:
            for t in fails_sets[f]:
                if t not in cold_tags.get(f, set()):
                    # keep the NEWEST confirmation: known_bad_at's check is
                    # one-sided (g - s <= ttl), so the max stamp dominates
                    # every older one.  Plain assignment let an EARLIER
                    # lead (leads iterate in trigger order, not frame
                    # order) overwrite a later frame's stamp — measured on
                    # the 534-frame bench: tags 29/34/35's frame-518/428
                    # confirmations were clobbered by lead 220, un-
                    # suppressing 70 round-2 audits of absences cold had
                    # already confirmed (82 trigger frames, 227/233
                    # audited failures confirmed-absent).
                    self.known_bad[t] = max(
                        self.known_bad.get(t, -(1 << 60)), self.g0 + f
                    )
            if added.get(f, False) and f not in plan.light_set:
                improved.append(f)
        return improved

    def resweep_jobs(
        self, improved: List[int], no_resweep: Set[int]
    ) -> List[Tuple[List[int], Tuple[int, int, int]]]:
        """Build the repair re-sweep jobs from this round's improvements.

        One job per row, seeded from the EARLIEST (in sweep order)
        improved frame: (frames downstream of the seed in sweep order,
        (f1 nearest seed, f2, f3)).  Rows in no_resweep are skipped.
        """
        best: Dict[int, int] = {}
        for f in improved:
            r = int(self.layout.row_of[f])
            if r < 0 or r in no_resweep:
                continue
            if r not in best or self.layout.pos_of[f] < self.layout.pos_of[best[r]]:
                best[r] = f
        jobs: List[Tuple[List[int], Tuple[int, int, int]]] = []
        for r, f in best.items():
            rest = self.layout.row_frames[r][int(self.layout.pos_of[f]) + 1 :]
            if not rest:
                continue
            d = 1 if r % 2 == 0 else -1  # even rows sweep forward
            jobs.append((rest, (f, f - d, f - 2 * d)))
        return jobs
