"""Camera model projections as torch functions.

Port of ``ccrs_tpu/models/projections.py``, all six models:

===========  =========================================  ==========
name         params                                     n_params
===========  =========================================  ==========
ucm          fx fy cx cy alpha                          5
eucm         fx fy cx cy alpha beta                     6
eucmt        fx fy cx cy alpha beta t1 t2               8
kb4          fx fy cx cy k1 k2 k3 k4                    8
opencv5      fx fy cx cy k1 k2 p1 p2 k3                 9
ftheta       fx fy cx cy k1 k2 k3 k4 k5                 9
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

Iterative inversions (EUCMT's tangential warp, KB4/FTHETA's angle
polynomial, OPENCV5's undistortion) run a fixed number of steps, never a
tolerance loop, so they trace like the rest.
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


def project_eucmt(params, p3d):
    fx, fy, cx, cy, alpha, beta, t1, t2 = (params[..., i] for i in range(8))
    _, valid, (mx, my) = _eucm_core(fx, fy, cx, cy, alpha, beta, p3d)
    r2 = mx * mx + my * my
    mxp = mx + 2.0 * t1 * mx * my + t2 * (r2 + 2.0 * mx * mx)
    myp = my + t1 * (r2 + 2.0 * my * my) + 2.0 * t2 * mx * my
    u = fx * mxp + cx
    v = fy * myp + cy
    return torch.stack([u, v], dim=-1), valid


def unproject_eucmt(params, p2d):
    fx, fy, cx, cy, alpha, beta, t1, t2 = (params[..., i] for i in range(8))
    mxd = _safe_div(p2d[..., 0] - cx, fx)
    myd = _safe_div(p2d[..., 1] - cy, fy)
    # invert the tangential warp by fixed-point iteration (contractive for
    # calibration-magnitude t1/t2)
    mx, my = mxd, myd
    for _ in range(8):
        r2 = mx * mx + my * my
        dx = 2.0 * t1 * mx * my + t2 * (r2 + 2.0 * mx * mx)
        dy = t1 * (r2 + 2.0 * my * my) + 2.0 * t2 * mx * my
        mx = mxd - dx
        my = myd - dy
    mz, valid = _eucm_unproject_core(alpha, beta, mx, my)
    return torch.stack([mx, my, mz], dim=-1), valid & (mz > _EPS)


# ----------------------------------------------------------- KB4 / FTHETA


def _theta_poly(theta, ks):
    """theta * (1 + k1 th^2 + k2 th^4 + ...) via Horner on theta^2."""
    th2 = theta * theta
    acc = torch.zeros_like(theta)
    for k in ks[::-1]:
        acc = (acc + k) * th2
    return theta * (1.0 + acc)


def _invert_theta_poly(theta_d, ks, iters=10):
    """Newton-solve theta from theta_d = poly(theta); fixed iterations."""
    theta = theta_d
    for _ in range(iters):
        th2 = theta * theta
        acc = torch.zeros_like(theta)
        dacc = torch.zeros_like(theta)
        for i, k in list(enumerate(ks))[::-1]:
            acc = (acc + k) * th2
            dacc = (dacc + (2 * i + 3) * k) * th2
        f = theta * (1.0 + acc) - theta_d
        fp = 1.0 + dacc
        theta = theta - _safe_div(f, fp)
    return theta


def _project_theta_poly(params, p3d, n_ks):
    """Shared body of KB4 and FTHETA: the pixel radius is an odd polynomial
    of the incidence angle."""
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(n_ks)]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r = _safe_sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    theta_d = _theta_poly(theta, ks)
    # scale = theta_d / r, with the r->0 limit theta_d/r -> 1/z
    near_axis = r < 1e-8
    scale = torch.where(near_axis, _safe_div(torch.ones_like(z), z), _safe_div(theta_d, r))
    u = fx * scale * x + cx
    v = fy * scale * y + cy
    valid = ~(near_axis & (z <= 0.0))
    return torch.stack([u, v], dim=-1), valid


def _unproject_theta_poly(params, p2d, n_ks):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(n_ks)]
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    rd = _safe_sqrt(mx * mx + my * my)
    theta = _invert_theta_poly(rd, ks)
    s = torch.sin(theta)
    c = torch.cos(theta)
    near0 = rd < 1e-12
    dirx = torch.where(near0, mx, s * _safe_div(mx, rd))
    diry = torch.where(near0, my, s * _safe_div(my, rd))
    # rays with z>0 are valid (FOV <= 180 deg, usable downstream as x/z)
    valid = c > _EPS
    return torch.stack([dirx, diry, c], dim=-1), valid


def project_kb4(params, p3d):
    return _project_theta_poly(params, p3d, 4)


def unproject_kb4(params, p2d):
    return _unproject_theta_poly(params, p2d, 4)


def project_ftheta(params, p3d):
    """NVidia-style f-theta fisheye: pixel radius is an odd polynomial of the
    incidence angle, r_d(theta) = theta * (1 + k1 th^2 + ... + k5 th^10).

    Semantic-parity caveat (PARITY.md "FTHETA semantic-parity note"): the
    reference's FTHETA lives in the unvendored `camera-intrinsic-model`
    crate and could not be diffed offline; NVidia's published spec also
    carries a backward polynomial and a linear extension region that this
    implementation, like the JAX package's, does not.
    """
    return _project_theta_poly(params, p3d, 5)


def unproject_ftheta(params, p2d):
    return _unproject_theta_poly(params, p2d, 5)


# ------------------------------------------------------------------- OPENCV5


def project_opencv5(params, p3d):
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = (params[..., i] for i in range(9))
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    valid = z > _EPS
    xp = _safe_div(x, z)
    yp = _safe_div(y, z)
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xpp = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    ypp = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    u = fx * xpp + cx
    v = fy * ypp + cy
    return torch.stack([u, v], dim=-1), valid


def unproject_opencv5(params, p2d):
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = (params[..., i] for i in range(9))
    xd = _safe_div(p2d[..., 0] - cx, fx)
    yd = _safe_div(p2d[..., 1] - cy, fy)
    # OpenCV-style fixed-point undistort iteration
    x, y = xd, yd
    for _ in range(12):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = _safe_div(xd - dx, radial)
        y = _safe_div(yd - dy, radial)
    ones = torch.ones_like(x)
    return torch.stack([x, y, ones], dim=-1), torch.ones_like(x, dtype=torch.bool)


# ------------------------------------------------------------------ dispatch

_PROJECT = {
    "ucm": project_ucm,
    "eucm": project_eucm,
    "eucmt": project_eucmt,
    "kb4": project_kb4,
    "opencv5": project_opencv5,
    "ftheta": project_ftheta,
}
_UNPROJECT = {
    "ucm": unproject_ucm,
    "eucm": unproject_eucm,
    "eucmt": unproject_eucmt,
    "kb4": unproject_kb4,
    "opencv5": unproject_opencv5,
    "ftheta": unproject_ftheta,
}


def project_fn(name: str):
    return _PROJECT[name]


def unproject_fn(name: str):
    return _UNPROJECT[name]


def project(name: str, params, p3d):
    return _PROJECT[name](params, p3d)


def unproject(name: str, params, p2d):
    return _UNPROJECT[name](params, p2d)
