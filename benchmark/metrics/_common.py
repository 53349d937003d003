"""Shared arithmetic of the metric readers (not a metric itself)."""


def mean_span_ms(run, name: str):
    """Mean seconds per job of the benchmark's span ``name``, in ms; None
    where no job opened it."""
    vals = [s[name] for s in run.spans if name in s]
    return 1000.0 * sum(vals) / len(vals) if vals else None


def idle_pct(run):
    """Share of the traced window in which nothing ran on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def threshold_bytes(shapes) -> int:
    """Bytes the threshold kernel must move: each input byte read once and
    each output byte written once.  ``shapes``: (B, H, W, itemsize, scale)
    per launch; the output is (B, sH padded to 4, sW padded to 8 / 8)
    packed bits with sH = H // scale, sW = W // scale."""
    total = 0
    for B, H, W, item, scale in shapes:
        sH, sW = H // scale, W // scale
        total += B * H * W * item + B * (sH + (-sH) % 4) * ((sW + (-sW) % 8) // 8)
    return total
