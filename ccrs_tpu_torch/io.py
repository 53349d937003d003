"""JSON + report IO, byte-compatible with the reference (``src/io.rs``);
copy of ``ccrs_tpu/io.py``."""

from __future__ import annotations

import json
from typing import Any


def object_to_json(output_path: str, obj: Any) -> None:
    """Pretty JSON with 2-space indent (serde_json pretty), ``src/io.rs:6-10``."""
    if hasattr(obj, "to_json"):
        obj = obj.to_json()
    with open(output_path, "w") as f:
        json.dump(obj, f, indent=2)


def object_from_json(file_path: str) -> Any:
    with open(file_path) as f:
        return json.load(f)


def write_report(output_path: str, with_extrinsic: bool, rep_rms) -> None:
    """Identical report format to ``src/io.rs:21-31``.

    ``rep_rms``: list of (avg_reproj_err, median_reproj_err) per camera.
    """
    s = f"Calibrate with extrinsics: {'true' if with_extrinsic else 'false'}\n\n"
    for cam_idx, (avg_rep, med_rep) in enumerate(rep_rms):
        s += f"cam{cam_idx}:\n"
        s += f"    average reprojection error: {avg_rep:.5f} px\n"
        s += f"    median  reprojection error: {med_rep:.5f} px\n\n"
    with open(output_path, "w") as f:
        f.write(s)
