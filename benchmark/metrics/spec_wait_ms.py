"""spec_wait_ms: the program's calib/spec-wait stage (the ladder's wait on
the speculation thread), summed over the cameras, mean per job."""

from metrics._program import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "calib/spec-wait")
