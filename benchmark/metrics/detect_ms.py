"""detect_ms: the benchmark's span from the first feed of a camera's
session to its finalize, summed over the cameras, mean per job."""

from metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "detect")
