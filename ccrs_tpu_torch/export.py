"""Result exporters: Kalibr camchain.yaml (copy of ``ccrs_tpu/export.py``).

Interop beyond the reference's JSON artifacts: most downstream VIO/SLAM
stacks (OpenVINS, VINS-Fusion, basalt, ...) consume Kalibr camchains.
Model mapping:

  ============  ====================  =================
  ccrs model    Kalibr camera_model   distortion_model
  ============  ====================  =================
  eucm          eucm [alpha, beta]    none
  ucm           omni [xi]             none  (alpha -> xi = a/(1-a), f' = f/(1-a))
  kb4           pinhole               equidistant [k1..k4]
  opencv5       pinhole               radtan [k1, k2, p1, p2]  (k3 dropped*)
  ============  ====================  =================

(*) Kalibr's radtan takes 4 coefficients; exporting an opencv5 calibration
with a significant k3 emits a warning.  eucmt/ftheta have no Kalibr
counterpart and raise.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .models import GenericModel
from .types import RvecTvec

log = logging.getLogger(__name__)


def _cam_entry(model: GenericModel) -> Dict:
    fx, fy, cx, cy = map(float, model.params[:4])
    if model.name == "eucm":
        alpha, beta = map(float, model.params[4:6])
        return {
            "camera_model": "eucm",
            "intrinsics": [fx, fy, cx, cy, alpha, beta],
            "distortion_model": "none",
            "distortion_coeffs": [],
        }
    if model.name == "ucm":
        # UCM(alpha) == Mei omni(xi) with xi = a/(1-a), f' = f/(1-a)
        a = float(model.params[4])
        s = 1.0 / max(1.0 - a, 1e-9)
        return {
            "camera_model": "omni",
            "intrinsics": [a * s, fx * s, fy * s, cx, cy],
            "distortion_model": "radtan",
            "distortion_coeffs": [0.0, 0.0, 0.0, 0.0],
        }
    if model.name == "kb4":
        return {
            "camera_model": "pinhole",
            "intrinsics": [fx, fy, cx, cy],
            "distortion_model": "equidistant",
            "distortion_coeffs": [float(k) for k in model.params[4:8]],
        }
    if model.name == "opencv5":
        k1, k2, p1, p2, k3 = map(float, model.params[4:9])
        if abs(k3) > 1e-6:
            log.warning("camchain export drops opencv5 k3=%.2e (radtan has 4 coeffs)", k3)
        return {
            "camera_model": "pinhole",
            "intrinsics": [fx, fy, cx, cy],
            "distortion_model": "radtan",
            "distortion_coeffs": [k1, k2, p1, p2],
        }
    raise ValueError(f"no Kalibr counterpart for model {model.name!r}")


def write_camchain(
    path: str,
    intrinsics: List[GenericModel],
    t_cam_i_0: Optional[List[RvecTvec]] = None,
) -> None:
    """Write a Kalibr camchain.yaml.

    ``t_cam_i_0[i]`` maps cam0-frame points into cam i (this framework's
    extrinsic convention); Kalibr's ``T_cn_cnm1`` maps cam (i-1) points
    into cam i, so adjacent-pair transforms are chained accordingly.
    """
    import yaml

    chain = {}
    for i, model in enumerate(intrinsics):
        entry = _cam_entry(model)
        entry["resolution"] = [int(round(model.width)), int(round(model.height))]
        if t_cam_i_0 is not None and i > 0:
            # T_ci_ci-1 = T_ci_c0 * inv(T_ci-1_c0)
            t = t_cam_i_0[i].compose(t_cam_i_0[i - 1].inverse())
            entry["T_cn_cnm1"] = [[float(v) for v in row] for row in t.to_matrix()]
        chain[f"cam{i}"] = entry
    with open(path, "w") as f:
        yaml.safe_dump(chain, f, default_flow_style=None, sort_keys=True)
