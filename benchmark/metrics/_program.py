"""Readers of the program's own stages and counters (not a metric itself)."""


def mean_stage_ms(run, *names):
    """Seconds per job of the program's stages ``names`` (summed, over every
    camera), in ms, mean over the jobs; None where no job opened any."""
    jobs = [j["stages"] for j in run.per_job]
    if not any(n in s for s in jobs for n in names):
        return None
    return 1000.0 * sum(s.get(n, 0.0) for s in jobs for n in names) / len(jobs)


def counter_pct(part: str, whole: str):
    """100 x counter ``part`` over counter ``whole`` of the program's
    counters over the window (the traced run resets them before it); None
    where the program has no counters or ``whole`` is 0."""
    from ccrs_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
