"""detect_span_ms: the program's detect/tracked stage (one camera's tracked
detection), summed over the cameras, mean per job."""

from metrics._program import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "detect/tracked")
