"""idle_no_stage_pct: the card's idle time in the traced window while no
program stage was open on the main thread, over the window, in %.  Where
that label is not among the digest's listed gaps and the list is full, the
smallest listed gap bounds it from above."""

LABEL = "no stage open"
LISTED = 10  # the digest lists the ten longest gaps


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    gaps = t["idle_gaps"]
    found = [s for n, s in gaps if n == LABEL]
    if found:
        idle = sum(found)
    elif len(gaps) >= LISTED:
        idle = min(s for _, s in gaps)
    else:
        idle = 0.0
    return 100.0 * idle / t["window_s"]
