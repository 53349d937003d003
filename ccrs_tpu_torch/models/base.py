"""GenericModel: the universal camera handle (host side).

Port of ``ccrs_tpu/models/base.py``: metadata, parameter packing, bounds
and the reference's tagged-enum JSON (``src/util.rs:38-49,245-282``).
Compute goes through the torch functions in
:mod:`ccrs_tpu_torch.models.projections`; the host convenience wrappers
``project``/``unproject`` evaluate them in float64 on the CPU.
``project_on`` / ``unproject_on`` evaluate them on the tensors' device, on
the card as one captured graph per (model, shape): the counterpart of the
JAX package's ``_project_jit`` / ``_unproject_jit``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch

from .. import graphs
from . import projections as P

# JSON tag (serde external tagging) and parameter field order per model.
_JSON_TAG = {
    "ucm": "UCM",
    "eucm": "EUCM",
    "eucmt": "EUCMT",
    "kb4": "KannalaBrandt4",
    "opencv5": "OpenCVModel5",
    "ftheta": "FTheta",
}
_PARAM_FIELDS = {
    "ucm": ["fx", "fy", "cx", "cy", "alpha"],
    "eucm": ["fx", "fy", "cx", "cy", "alpha", "beta"],
    "eucmt": ["fx", "fy", "cx", "cy", "alpha", "beta", "t1", "t2"],
    "kb4": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "opencv5": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"],
    "ftheta": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4", "k5"],
}
_TAG_TO_NAME = {v.lower(): k for k, v in _JSON_TAG.items()}
_TAG_TO_NAME.update({k: k for k in _JSON_TAG})  # accept CLI names too
_TAG_TO_NAME.update({"kannalabrandt4": "kb4", "opencvmodel5": "opencv5"})

# Box bounds on distortion parameters, index -> (lower, upper)
# (src/util.rs:40-48, alpha bound from src/util.rs:346).
_DISTORTION_BOUNDS: Dict[str, Dict[int, Tuple[float, float]]] = {
    "ucm": {4: (1e-6, 1.0)},
    "eucm": {4: (1e-6, 1.0), 5: (1e-6, 10.0)},
    "eucmt": {4: (1e-6, 1.0), 5: (1e-6, 10.0), 6: (-1.0, 1.0), 7: (-1.0, 1.0)},
    "kb4": {},
    "opencv5": {},
    "ftheta": {},
}

MODEL_NAMES = P.MODEL_NAMES
N_PARAMS = P.N_PARAMS


@dataclasses.dataclass
class GenericModel:
    """A camera model instance: static name + parameter vector + image size."""

    name: str
    params: np.ndarray
    width: float
    height: float

    def __init__(self, name: str, params, width, height):
        name = name.lower()
        if name not in P.MODEL_NAMES:
            raise ValueError(f"unknown camera model {name!r}")
        params = np.asarray(params, dtype=np.float64).reshape(-1)
        if params.shape[0] != P.N_PARAMS[name]:
            raise ValueError(
                f"{name} expects {P.N_PARAMS[name]} params, got {params.shape[0]}"
            )
        self.name = name
        self.params = params
        self.width = float(width)
        self.height = float(height)

    # ------------------------------------------------------------- metadata
    @property
    def n_params(self) -> int:
        return P.N_PARAMS[self.name]

    def camera_params(self) -> np.ndarray:
        """fx fy cx cy (reference `camera_params`)."""
        return self.params[:4].copy()

    def distortion_params_bound(self) -> Dict[int, Tuple[float, float]]:
        return dict(_DISTORTION_BOUNDS[self.name])

    def set_params(self, params) -> None:
        params = np.asarray(params, dtype=np.float64).reshape(-1)
        if params.shape[0] != self.n_params:
            raise ValueError("bad param length")
        self.params = params

    def set_w_h(self, w, h) -> None:
        self.width = float(w)
        self.height = float(h)

    def copy(self) -> "GenericModel":
        return GenericModel(self.name, self.params.copy(), self.width, self.height)

    # -------------------------------------------------------------- compute
    def project(self, p3d) -> Tuple[np.ndarray, np.ndarray]:
        """(N,3) -> ((N,2) pixels, (N,) valid), float64 on the CPU."""
        f64 = torch.float64
        p2d, valid = P.project(
            self.name,
            torch.as_tensor(self.params, dtype=f64, device="cpu"),
            torch.as_tensor(np.asarray(p3d), dtype=f64, device="cpu"),
        )
        return p2d.numpy(), valid.numpy()

    def unproject(self, p2d) -> Tuple[np.ndarray, np.ndarray]:
        f64 = torch.float64
        p3d, valid = P.unproject(
            self.name,
            torch.as_tensor(self.params, dtype=f64, device="cpu"),
            torch.as_tensor(np.asarray(p2d), dtype=f64, device="cpu"),
        )
        return p3d.numpy(), valid.numpy()

    # ------------------------------------------------------------------ JSON
    def to_json(self) -> dict:
        fields = _PARAM_FIELDS[self.name]
        inner = {f: float(v) for f, v in zip(fields, self.params)}
        inner["width"] = int(round(self.width)) if float(self.width).is_integer() else self.width
        inner["height"] = int(round(self.height)) if float(self.height).is_integer() else self.height
        return {_JSON_TAG[self.name]: inner}

    @staticmethod
    def from_json(obj: dict) -> "GenericModel":
        if len(obj) != 1:
            raise ValueError("model JSON must be a single-tag object")
        tag, inner = next(iter(obj.items()))
        name = _TAG_TO_NAME.get(tag.lower())
        if name is None:
            raise ValueError(f"unknown model tag {tag!r}")
        fields = _PARAM_FIELDS[name]
        params = [float(inner[f]) for f in fields]
        return GenericModel(name, params, inner["width"], inner["height"])


def project_on(name: str, params, p3d):
    """``projections.project`` on the tensors' device: on the card one
    graph per (model, shapes), elsewhere eagerly."""
    return graphs.call(P.project, (name,), (params, p3d))


def unproject_on(name: str, params, p2d):
    """``projections.unproject`` on the tensors' device, as ``project_on``."""
    return graphs.call(P.unproject, (name,), (params, p2d))


def model_to_json(path: str, model: GenericModel) -> None:
    """Write the tagged-enum JSON (byte-layout like `data/eucm.json`)."""
    with open(path, "w") as f:
        json.dump(model.to_json(), f, indent=2)


def model_from_json(path: str) -> GenericModel:
    with open(path) as f:
        return GenericModel.from_json(json.load(f))


def zeros_like_model(name: str, width=0, height=0) -> GenericModel:
    return GenericModel(name, np.zeros(P.N_PARAMS[name]), width, height)
