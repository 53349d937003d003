"""Camera model library: UCM/EUCM project/unproject as torch functions."""

from .base import (
    MODEL_NAMES,
    N_PARAMS,
    GenericModel,
    model_from_json,
    model_to_json,
    zeros_like_model,
)
from .projections import project, project_fn, unproject, unproject_fn

__all__ = [
    "MODEL_NAMES",
    "N_PARAMS",
    "GenericModel",
    "model_from_json",
    "model_to_json",
    "zeros_like_model",
    "project",
    "project_fn",
    "unproject",
    "unproject_fn",
]
