"""Camera model projections as torch functions (UCM and EUCM).

Port of the UCM/EUCM part of ``ccrs_tpu/models/projections.py``:

===========  =========================================  ==========
name         params                                     n_params
===========  =========================================  ==========
ucm          fx fy cx cy alpha                          5
eucm         fx fy cx cy alpha beta                     6
===========  =========================================  ==========

- ``project(params, p3d) -> (p2d, valid)``: p3d is ``(..., 3)`` in camera
  frame, p2d is ``(..., 2)`` pixels; ``valid`` is the reference's Option
  mask.
- ``unproject(params, p2d) -> (p3d, valid)``: a ray with the EUCM z
  component, as the reference returns it.
- dtype-polymorphic (float32 image paths, float64 solver paths) and free of
  data-dependent Python branches, so ``torch.func.jacfwd``/``vmap`` trace
  them; every division and square root keeps the ``where`` guard that
  holds the unselected branch finite.

The other four models of the JAX package (EUCMT, KB4, OPENCV5, FTHETA) are
not ported yet (ROADMAP A.10).
"""

from __future__ import annotations

import torch

__all__ = [
    "MODEL_NAMES",
    "N_PARAMS",
    "project",
    "unproject",
    "project_fn",
    "unproject_fn",
]

MODEL_NAMES = ("ucm", "eucm", "eucmt", "kb4", "opencv5", "ftheta")
N_PARAMS = {
    "ucm": 5,
    "eucm": 6,
    "eucmt": 8,
    "kb4": 8,
    "opencv5": 9,
    "ftheta": 9,
}

_EPS = 1e-12


def _safe_div(num, den, eps=_EPS):
    """num/den with gradient-safe guard; caller masks invalid outputs."""
    signed_eps = torch.where(
        den >= 0, torch.full_like(den, eps), torch.full_like(den, -eps)
    )
    return num / torch.where(den.abs() > eps, den, signed_eps)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _eucm_core(fx, fy, cx, cy, alpha, beta, p3d):
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    d = _safe_sqrt(beta * (x * x + y * y) + z * z)
    denom = alpha * d + (1.0 - alpha) * z
    # valid projection region: z > -w*d  (DS paper eq. (22)-(23))
    w = torch.where(
        alpha <= 0.5, _safe_div(alpha, 1.0 - alpha), _safe_div(1.0 - alpha, alpha)
    )
    valid = (z > -w * d) & (denom > _EPS)
    mx = _safe_div(x, denom)
    my = _safe_div(y, denom)
    u = fx * mx + cx
    v = fy * my + cy
    return torch.stack([u, v], dim=-1), valid, (mx, my)


def project_ucm(params, p3d):
    fx, fy, cx, cy, alpha = (params[..., i] for i in range(5))
    p2d, valid, _ = _eucm_core(fx, fy, cx, cy, alpha, torch.ones_like(alpha), p3d)
    return p2d, valid


def project_eucm(params, p3d):
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    p2d, valid, _ = _eucm_core(fx, fy, cx, cy, alpha, beta, p3d)
    return p2d, valid


def _eucm_unproject_core(alpha, beta, mx, my):
    r2 = mx * mx + my * my
    gamma = 1.0 - alpha
    inner = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    mz = _safe_div(1.0 - beta * alpha * alpha * r2, alpha * _safe_sqrt(inner) + gamma)
    valid = torch.where(alpha > 0.5, inner >= 0.0, torch.ones_like(inner, dtype=torch.bool))
    return mz, valid


def unproject_ucm(params, p2d):
    fx, fy, cx, cy, alpha = (params[..., i] for i in range(5))
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    mz, valid = _eucm_unproject_core(alpha, torch.ones_like(alpha), mx, my)
    return torch.stack([mx, my, mz], dim=-1), valid & (mz > _EPS)


def unproject_eucm(params, p2d):
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    mz, valid = _eucm_unproject_core(alpha, beta, mx, my)
    return torch.stack([mx, my, mz], dim=-1), valid & (mz > _EPS)


_PROJECT = {"ucm": project_ucm, "eucm": project_eucm}
_UNPROJECT = {"ucm": unproject_ucm, "eucm": unproject_eucm}


def _lookup(table, name: str):
    if name not in table:
        raise NotImplementedError(
            f"camera model {name!r} is not ported to ccrs_tpu_torch yet "
            "(ROADMAP A.10)"
        )
    return table[name]


def project_fn(name: str):
    return _lookup(_PROJECT, name)


def unproject_fn(name: str):
    return _lookup(_UNPROJECT, name)


def project(name: str, params, p3d):
    return project_fn(name)(params, p3d)


def unproject(name: str, params, p2d):
    return unproject_fn(name)(params, p2d)
