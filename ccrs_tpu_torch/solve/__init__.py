"""Solver kit: SE(3), planar PnP, RANSAC homography, LM/Schur BA cores."""

from . import se3
from .homography import (
    homography_to_focal,
    homography_to_focal_traced,
    radial_distortion_homography,
)
from .lm import (
    BAResult,
    LMOptions,
    MultiBAResult,
    ba_solve,
    ba_solve_multi,
    expand_theta,
    lm_solve,
    reduce_params,
)
from .pnp import homography_dlt, solve_pnp_planar, solve_pnp_planar_batch

__all__ = [
    "se3",
    "homography_to_focal",
    "homography_to_focal_traced",
    "radial_distortion_homography",
    "BAResult",
    "LMOptions",
    "MultiBAResult",
    "ba_solve",
    "ba_solve_multi",
    "expand_theta",
    "lm_solve",
    "reduce_params",
    "homography_dlt",
    "solve_pnp_planar",
    "solve_pnp_planar_batch",
]
