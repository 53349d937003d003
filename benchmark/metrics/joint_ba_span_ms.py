"""joint_ba_span_ms: the program's joint/init-extrinsic and joint/ba stages
(init_camera_extrinsic and calib_all_camera_with_extrinsics), mean per job."""

from metrics._program import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "joint/init-extrinsic", "joint/ba")
