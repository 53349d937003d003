"""joint_ba_ms: the benchmark's span around init_camera_extrinsic and
calib_all_camera_with_extrinsics, mean per job (video cells)."""

from metrics._common import mean_span_ms


def read(run):
    return mean_span_ms(run, "joint_ba")
