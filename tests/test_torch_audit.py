"""The port's audit policy (ccrs_tpu_torch/detect/audit.py) against the
JAX package's.

The scenarios of tests/test_audit.py run on the port's policy: suspect
classification, lead-frame selection, known_bad TTL (including its
one-sided, backwards-reaching window) and resweep-job transitions.  Then
seeded random observation streams go through both policies side by side
and every round must give the same plan, the same known_bad stamps, the
same improved frames and the same resweep jobs.
"""

from __future__ import annotations

import numpy as np
import pytest

from ccrs_tpu.detect import audit as jax_audit
from ccrs_tpu_torch.detect import audit as port_audit
from ccrs_tpu_torch.detect.audit import AuditPolicy, RoundPlan, RowLayout
from ccrs_tpu_torch.detect.track import MIN_TRACK_TAGS

N_TAGS = 36
K = 40


def make_layout(B, rows):
    """rows: {row_id: [frames in sweep order]}."""
    lay = RowLayout.empty(B)
    for r, fl in rows.items():
        lay.row_frames[r] = list(fl)
        for w, f in enumerate(fl):
            lay.row_of[f] = r
            lay.pos_of[f] = w
    return lay


def make_policy(B=20, rows=None, seg_expect=None, known_bad=None, g0=0):
    rows = rows if rows is not None else {0: list(range(3, B))}
    lay = make_layout(B, rows)
    seg = seg_expect if seg_expect is not None else {0: N_TAGS}
    return AuditPolicy(
        n_tags=N_TAGS, g0=g0, known_bad=known_bad if known_bad is not None else {},
        kb_ttl=2 * K, layout=lay, seg_expect=seg,
    )


def healthy(B):
    """No failures, full acceptance."""
    return [set() for _ in range(B)], np.full(B, N_TAGS)


def test_no_suspects_terminates():
    pol = make_policy()
    fails, acc = healthy(20)
    assert pol.plan_round(fails, acc, set()) is None
    assert pol.rounds == 0


def test_three_novel_failures_is_heavy():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}
    plan = pol.plan_round(fails, acc, set())
    assert plan is not None
    assert 5 in plan.lead
    assert 5 not in plan.light_set


def test_low_acceptance_is_heavy_even_without_failures():
    pol = make_policy()
    fails, acc = healthy(20)
    acc[7] = MIN_TRACK_TAGS - 1
    plan = pol.plan_round(fails, acc, set())
    assert plan is not None and 7 in plan.lead


def test_anchor_expectation_lowers_the_bar():
    # a frame seeing 8 tags is healthy when its segment's anchors see 10
    pol = make_policy(seg_expect={0: 10})
    fails, acc = healthy(20)
    acc[5] = 8  # >= expected(10) - 4 slack and >= MIN_TRACK_TAGS
    assert pol.plan_round(fails, acc, set()) is None
    acc[5] = 5  # below 10 - 4
    plan = pol.plan_round(fails, acc, set())
    assert plan is not None and 5 in plan.lead


def test_light_suspect_sweeps_alone_when_no_heavy():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[6] = {4}  # 1 flickering tag, healthy count
    plan = pol.plan_round(fails, acc, set())
    assert plan is not None
    assert plan.lead == [6]
    assert plan.light_set == {6}


def test_light_waits_for_heavy_round_then_joins():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}  # heavy
    fails[10] = {7}  # light
    plan1 = pol.plan_round(fails, acc, set())
    assert 5 in plan1.lead and 10 not in plan1.lead  # light waits
    # round 2: the light suspect joins (and no resweeps are allowed)
    plan2 = pol.plan_round(fails, acc, {5})
    assert 10 in plan2.lead and 10 in plan2.light_set
    assert int(pol.layout.row_of[10]) in plan2.no_resweep


def test_lead_per_row_audits_only_first_heavy():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}
    fails[8] = {1, 2, 3}  # same row, downstream — rides the resweep
    plan = pol.plan_round(fails, acc, set())
    assert plan.lead == [5]


def test_rowless_heavy_frames_all_audit():
    pol = make_policy(rows={})  # no wave rows (e.g. cold-direct layout)
    fails, acc = healthy(20)
    fails[4] = {1, 2, 3}
    fails[9] = {4, 5, 6}
    plan = pol.plan_round(fails, acc, set())
    assert plan.lead == [4, 9]
    assert plan.no_resweep == set()


def test_mass_failure_sends_row_cold_no_resweep():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = set(range(N_TAGS // 4))  # mass failure at the lead
    fails[7] = {1, 2, 3}  # downstream, same tags: stamp-suppressed
    fails[9] = {20, 21, 22}  # downstream, NOVEL tags: audited round 2
    plan = pol.plan_round(fails, acc, set())
    # only the lead audits this round: its stamps suppress downstream
    # suspicion before round 2 plans the remainder (eager extension
    # measured 103-114 audits where staging audits ~74)
    assert plan.lead == [5]
    # ...and the row is excluded from resweep-repair
    assert 0 in plan.no_resweep
    assert pol.resweep_jobs([5], plan.no_resweep) == []
    # round 2: frame 7's failures were cold-confirmed absent at the lead
    # (the stamp covers it), frame 9's novel tags still audit
    pol.record_outcome(plan, fails, {5: set()}, {5: False})
    plan2 = pol.plan_round(fails, acc, {5})
    assert plan2 is not None
    assert 7 not in plan2.lead and 9 in plan2.lead


def test_known_bad_ttl_suppresses_then_expires():
    kb = {}
    pol = make_policy(known_bad=kb)
    fails, acc = healthy(20)
    fails[5] = {2}
    plan = pol.plan_round(fails, acc, set())
    assert plan.lead == [5]
    # the audit confirms the absence (cold missed tag 2 too)
    improved = pol.record_outcome(plan, fails, {5: set()}, {5: False})
    assert improved == []
    assert kb[2] == 5  # stamped at g0 + f
    # same failure later in the TTL window: no longer novel
    fails2, acc2 = healthy(20)
    fails2[10] = {2}
    assert pol.plan_round(fails2, acc2, {5}) is None
    # a policy for a LATER batch (g0 past the TTL) re-triggers
    pol2 = make_policy(known_bad=kb, g0=5 + 2 * K + 1)
    plan2 = pol2.plan_round(fails2, acc2, set())
    assert plan2 is not None and 10 in plan2.lead


def test_known_bad_stamp_keeps_newest_confirmation():
    # leads iterate in TRIGGER order, not frame order: an early-frame lead
    # appearing later in the list must not clobber a later frame's stamp
    # (known_bad_at is one-sided, so the max stamp dominates — the r05
    # bench showed 70 redundant re-audits of already-confirmed absences
    # when lead 220 overwrote the frame-518 stamp for tags 29/34/35)
    kb = {}
    pol = make_policy(B=600, rows={0: list(range(3, 600))}, known_bad=kb)
    fails, acc = healthy(600)
    for f in (518, 220):  # trigger order: 518 first, then 220
        fails[f] = {29}
    plan = RoundPlan(lead=[518, 220], light_set=set(), no_resweep=set())
    pol.record_outcome(plan, fails, {518: set(), 220: set()},
                       {518: False, 220: False})
    assert kb[29] == 518  # newest confirmation wins
    # and the suppression window extends from the newest stamp
    fails2, acc2 = healthy(600)
    fails2[560] = {29}  # 560 - 518 <= 2K: suppressed
    assert pol.plan_round(fails2, acc2, {518, 220}) is None


def test_recovered_tag_is_not_stamped_known_bad():
    kb = {}
    pol = make_policy(known_bad=kb)
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}
    plan = pol.plan_round(fails, acc, set())
    # cold recovered tags 1 and 2 but confirmed 3 absent
    improved = pol.record_outcome(plan, fails, {5: {1, 2}}, {5: True})
    assert improved == [5]
    assert 1 not in kb and 2 not in kb and kb[3] == 5


def test_light_frames_never_seed_resweeps():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[6] = {4}
    plan = pol.plan_round(fails, acc, set())
    assert plan.light_set == {6}
    improved = pol.record_outcome(plan, fails, {6: {4}}, {6: True})
    assert improved == []  # recovered, but light: no resweep seed


def test_resweep_jobs_earliest_improved_and_direction():
    # even row 0 sweeps forward over 3..12; odd row 1 backward over 18..13
    rows = {0: list(range(3, 13)), 1: list(range(18, 12, -1))}
    pol = make_policy(rows=rows, seg_expect={0: N_TAGS})
    jobs = pol.resweep_jobs([7, 5, 16], set())
    jobs = sorted(jobs, key=lambda j: j[1][0])
    # row 0: earliest improved (pos order) is 5 -> resweep 6.., seeds 5,4,3
    assert jobs[0] == (list(range(6, 13)), (5, 4, 3))
    # row 1 (backward): frame 16 at pos 2 -> resweep 15..13, seeds 16,17,18
    assert jobs[1] == ([15, 14, 13], (16, 17, 18))


def test_round2_audits_all_remaining_heavy_in_one_sweep():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}
    pol.plan_round(fails, acc, set())  # round 1
    fails[8] = {1, 2, 3}
    fails[11] = {4, 5, 6}
    plan2 = pol.plan_round(fails, acc, {5})
    assert set(plan2.lead) == {8, 11}  # no lead-per-row collapsing
    # every row is resweep-blocked (the loop's termination guarantee)
    assert pol.resweep_jobs([8], plan2.no_resweep) == []


def test_frames_already_cold_never_retrigger():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}
    assert pol.plan_round(fails, acc, {5}) is None


def test_trigger_log_records_novel_failures():
    pol = make_policy()
    fails, acc = healthy(20)
    fails[5] = {3, 1, 2}
    pol.plan_round(fails, acc, set())
    assert pol.trigger_log == [(5, [1, 2, 3])]


def test_lead_per_row_backward_row_uses_sweep_order():
    """Odd rows sweep BACKWARD: the lead must be the earliest heavy frame
    in SWEEP order (min pos_of), not the lowest frame index — picking the
    ascending-frame first suspect there chose the sweep-tail frame, whose
    resweep window is empty, so the repair mechanism never fired."""
    # row 1 sweeps frames 19..3 backward (pos 0 = frame 19)
    rows = {1: list(range(19, 2, -1))}
    pol = make_policy(rows=rows, seg_expect={0: N_TAGS})
    fails, acc = healthy(20)
    fails[5] = {1, 2, 3}   # sweep-late (pos 14)
    fails[12] = {1, 2, 3}  # sweep-early (pos 7) -> must be the lead
    plan = pol.plan_round(fails, acc, set())
    assert plan.lead == [12]
    # an improvement at the lead reseeds the DOWNSTREAM (backward) rest
    jobs = pol.resweep_jobs([12], plan.no_resweep)
    assert len(jobs) == 1
    rest, seeds = jobs[0]
    assert rest[0] == 11 and 5 in rest  # frames after 12 in sweep order
    assert seeds == (12, 13, 14)  # f-d, with d=-1 for odd rows


def test_known_bad_suppresses_backwards_in_time():
    """known_bad_at is one-sided (g - stamp <= ttl): a stamp also silences
    the tag at EARLIER frames, as in the JAX package."""
    kb = {7: 500}
    pol = make_policy(B=600, rows={0: list(range(3, 600))}, known_bad=kb)
    assert 7 in pol.known_bad_at(300)  # before the stamp
    assert 7 in pol.known_bad_at(500 + 2 * K)
    assert 7 not in pol.known_bad_at(500 + 2 * K + 1)
    ref = jax_audit.AuditPolicy(
        n_tags=N_TAGS, g0=0, known_bad=dict(kb), kb_ttl=2 * K,
        layout=jax_audit.RowLayout.empty(600), seg_expect={},
    )
    for f in (0, 300, 500, 579, 580, 581):
        assert pol.known_bad_at(f) == ref.known_bad_at(f)


def _random_case(rng, B):
    """A random row layout (forward/backward rows of random segments), a
    segment expectation per row pair and random failures/acceptances."""
    rows, f, seg = {}, 3, 0
    while f < B - 6:
        n = int(rng.integers(4, 14))
        fl = list(range(f, min(f + n, B)))
        half = (len(fl) + 1) // 2
        rows[2 * seg] = fl[:half]
        if fl[half:]:
            rows[2 * seg + 1] = fl[half:][::-1]
        f += n + 3
        seg += 1
    seg_expect = {s: int(rng.integers(6, N_TAGS + 1)) for s in range(seg)}
    fails = [set() for _ in range(B)]
    acc = np.full(B, N_TAGS)
    for f in rng.choice(B, size=B // 3, replace=False):
        k = int(rng.choice([1, 2, 3, 5, N_TAGS // 4]))
        fails[f] = set(int(t) for t in rng.choice(N_TAGS, size=k, replace=False))
        acc[f] = int(rng.integers(2, N_TAGS + 1))
    return rows, seg_expect, fails, acc


def _layout(mod, B, rows):
    lay = mod.RowLayout.empty(B)
    for r, fl in rows.items():
        lay.row_frames[r] = list(fl)
        for w, f in enumerate(fl):
            lay.row_of[f] = r
            lay.pos_of[f] = w
    return lay


@pytest.mark.parametrize("seed", range(6))
def test_policies_agree_round_by_round(seed):
    rng = np.random.default_rng(seed)
    B = 120
    rows, seg_expect, fails, acc = _random_case(rng, B)
    kb0 = {int(t): int(rng.integers(-100, 60)) for t in rng.choice(N_TAGS, 5, replace=False)}
    g0 = int(rng.integers(0, 80))
    pols = [
        mod.AuditPolicy(
            n_tags=N_TAGS, g0=g0, known_bad=dict(kb0), kb_ttl=2 * K,
            layout=_layout(mod, B, rows), seg_expect=dict(seg_expect),
        )
        for mod in (jax_audit, port_audit)
    ]
    in_cold = set(int(f) for f in rng.choice(B, size=10, replace=False))
    rounds = 0
    while True:
        plans = [p.plan_round(fails, acc, set(in_cold)) for p in pols]
        if plans[0] is None:
            assert plans[1] is None
            break
        a, b = plans
        assert (a.lead, a.light_set, a.no_resweep) == (b.lead, b.light_set, b.no_resweep)
        # a random cold outcome per audited frame, the same for both
        cold_tags = {
            f: set(t for t in fails[f] if rng.random() < 0.5) for f in a.lead
        }
        added = {f: bool(rng.random() < 0.5) for f in a.lead}
        improved = [p.record_outcome(pl, fails, cold_tags, added) for p, pl in zip(pols, plans)]
        assert improved[0] == improved[1]
        assert pols[0].known_bad == pols[1].known_bad
        jobs = [p.resweep_jobs(imp, pl.no_resweep) for p, imp, pl in zip(pols, improved, plans)]
        assert jobs[0] == jobs[1]
        in_cold |= set(a.lead)
        # the resweeps change what later rounds see: clear a few failures
        for f in list(in_cold)[:5]:
            fails[f] = set()
        rounds += 1
        assert rounds < 10
    assert rounds > 0
    assert pols[0].trigger_log == pols[1].trigger_log
    assert pols[0].rounds == pols[1].rounds
