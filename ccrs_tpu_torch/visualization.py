"""Observability sink (Rerun), with a no-op fallback (copy of
``ccrs_tpu/visualization.py``; numpy only).

Mirrors the reference's Rerun topic layout (SURVEY.md §5 "Metrics"):
``/cam{i}`` images, ``/cam{i}/pts`` labeled corners, ``/cam{i}/keyframe{j}``
markers, ``/cam{i}/board`` 3D points + reprojection text, ``/cam{i}/rep_err``
colored per-point errors, static camera transforms, RDF view coordinates,
``stable`` timeline keyed by frame time, and the +0.5 px pixel-center shift
(``src/visualization.rs:34-36``).  ``rerun-sdk`` is an optional dependency
(as in the reference's pyproject extras); without it every call is a no-op
so the pipeline is unaffected.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)

try:
    import rerun as rr

    HAVE_RERUN = True
except ImportError:  # pragma: no cover - environment without rerun
    rr = None
    HAVE_RERUN = False


def rerun_shift(p2ds: np.ndarray) -> np.ndarray:
    """+0.5 px pixel-center shift for display (src/visualization.rs:34-36)."""
    return np.asarray(p2ds) + 0.5


def id_to_color(idx: int):
    """Deterministic per-id color (reference seeds ChaCha8 with the id,
    src/visualization.rs:20-29; any stable id->color map serves the same
    purpose)."""
    rng = np.random.default_rng(np.uint64(idx) * np.uint64(2654435761) + 1)
    c = rng.integers(0, 2**24)
    return (int(c >> 16) % 256, int(c >> 8) % 256, int(c) % 256, 255)


def _failsafe(method):
    """Disable the recorder on the first rerun API error instead of taking
    the calibration down (rerun-sdk versions move fast and this module is
    exercised only when the optional dependency is installed)."""

    def wrapper(self, *args, **kwargs):
        if not self.active:
            return
        try:
            return method(self, *args, **kwargs)
        except Exception as e:  # pragma: no cover - depends on rerun version
            log.warning("rerun logging disabled after error: %s", e)
            self.active = False

    return wrapper


class Recorder:
    """Rerun recording wrapper; becomes a no-op when rerun is missing."""

    def __init__(self, path: Optional[str] = None, enabled: bool = True):
        self.active = bool(enabled and HAVE_RERUN and path)
        if enabled and path and not HAVE_RERUN:
            log.info("rerun-sdk not installed; skipping .rrd logging")
        if self.active:
            try:
                rr.init("calibration")
                rr.save(path)
                rr.log("/", rr.ViewCoordinates.RDF, static=True)
            except Exception as e:  # pragma: no cover
                log.warning("rerun init failed (%s); logging disabled", e)
                self.active = False

    def _time(self, t_ns: int):
        rr.set_time("stable", timestamp=np.datetime64(int(t_ns), "ns"))

    @_failsafe
    def log_camera_image(self, cam_idx: int, t_ns: int, img, detections: Dict):
        if not self.active:
            return
        self._time(t_ns)
        rr.log(f"cam{cam_idx}", rr.Image(np.asarray(img)).compress(jpeg_quality=85))
        if detections:
            pts, colors, labels = [], [], []
            for tid, corners in detections.items():
                for c in range(4):
                    pts.append(corners[c])
                    colors.append(id_to_color(tid * 4 + c))
                    labels.append(str(tid * 4 + c))
            rr.log(
                f"cam{cam_idx}/pts",
                rr.Points2D(
                    rerun_shift(np.asarray(pts)),
                    colors=colors,
                    labels=labels,
                    radii=rr.Radius.ui_points(2.0),
                ),
            )

    @_failsafe
    def log_keyframes(self, cam_idx: int, times_ns):
        if not self.active:
            return
        for j, t_ns in enumerate(times_ns):
            self._time(t_ns)
            rr.log(f"/cam{cam_idx}/keyframe{j}", rr.TextLog("keyframe"))

    @_failsafe
    def log_camera_transform(self, cam_idx: int, rtvec_inv_matrix: np.ndarray):
        if not self.active:
            return
        rr.log(
            f"/cam{cam_idx}",
            rr.Transform3D(
                translation=rtvec_inv_matrix[:3, 3], mat3x3=rtvec_inv_matrix[:3, :3],
                axis_length=0.1,
            ),
            static=True,
        )

    @_failsafe
    def log_validation(self, cam_idx, batch, board, model, rtvecs, per_frame):
        if not self.active:
            return
        for i, errs, p2ds in per_frame:
            rt = rtvecs[i]
            self._time(int(batch.time_ns[i]))
            p3c = rt.transform(board.p3d[batch.mask[i]])
            rr.log(f"/cam{cam_idx}/board", rr.Points3D(p3c))
            rr.log(
                f"/cam{cam_idx}/board/reprojection_err",
                rr.TextLog(f"{errs.mean()} px"),
            )
            v = np.clip(errs - 0.2, 0.0, 1.0)
            colors = np.stack(
                [255 * np.ones_like(v), 160 * (1 - v), np.zeros_like(v)], axis=1
            ).astype(np.uint8)
            rr.log(
                f"/cam{cam_idx}/rep_err",
                rr.Points2D(
                    rerun_shift(p2ds),
                    colors=colors,
                    labels=[f"{e}" for e in errs],
                    radii=rr.Radius.ui_points(1.0),
                ),
            )
