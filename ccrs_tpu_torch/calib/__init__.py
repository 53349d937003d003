"""Calibration orchestration: init, convert, single-cam BA, validation."""

from .convert import convert_model
from .frames import MIN_CORNERS, FrameBatch
from .initialize import find_best_two_frames, try_init_camera
from .pipeline import calibrate_camera_with_retries, init_and_calibrate_one_camera
from .single import calib_camera
from .validate import validation

__all__ = [
    "MIN_CORNERS",
    "FrameBatch",
    "calib_camera",
    "calibrate_camera_with_retries",
    "convert_model",
    "find_best_two_frames",
    "init_and_calibrate_one_camera",
    "try_init_camera",
    "validation",
]
