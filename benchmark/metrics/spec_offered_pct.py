"""spec_offered_pct: ladders that the speculation handed a warm seed
(calib/warm-offered) over ladders run (calib/cameras), in %, over the
window.  Beside spec_used_pct it tells a speculation that gave no seed
from a seed that the ladder's gate turned down."""

from metrics._program import counter_pct


def read(run):
    return counter_pct("calib/warm-offered", "calib/cameras")
