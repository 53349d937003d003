"""spec_used_pct: ladders whose result came from the speculation's warm
start (calib/warm-used) over ladders run (calib/cameras), in %, over the
window."""

from metrics._program import counter_pct


def read(run):
    return counter_pct("calib/warm-used", "calib/cameras")
