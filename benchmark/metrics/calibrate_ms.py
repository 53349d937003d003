"""calibrate_ms: the benchmark's span around calibrate_camera_with_retries,
summed over the cameras, mean per job."""

from metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "calibrate")
