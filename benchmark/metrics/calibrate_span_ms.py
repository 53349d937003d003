"""calibrate_span_ms: the program's calib/camera stage (one camera's
ladder, calibrate_camera_with_retries), summed over the cameras, mean per
job."""

from metrics._program import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "calib/camera")
