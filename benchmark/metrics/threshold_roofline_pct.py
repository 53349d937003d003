"""threshold_roofline_pct: the threshold kernel's least time (its bytes,
each input byte read once and each output byte written once, at the
card's peak rate) over its device time in the traced jobs."""

from metrics._common import threshold_bytes


def read(run):
    t = run.trace
    if t is None or t["threshold_s"] <= 0 or not t["threshold_shapes"]:
        return None
    return 100.0 * threshold_bytes(t["threshold_shapes"]) / run.peak_bw / t["threshold_s"]
