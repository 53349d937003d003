"""The EUCM camera model and rigid motions in plain torch, the benchmark's own.

EUCM (Khomenko et al. 2016), parameters ``fx fy cx cy alpha beta``:
``d = sqrt(beta (x^2 + y^2) + z^2)``, ``u = fx x / (alpha d + (1 - alpha) z)
+ cx`` and likewise for ``v``; UCM is EUCM with ``beta = 1``.  A point
projects where ``z > -w d`` with ``w = alpha / (1 - alpha)`` for
``alpha <= 0.5`` and ``(1 - alpha) / alpha`` above.  Poses are
axis-angle ``rvec`` and ``tvec`` of the board in the camera's frame.
Everything works in the dtype of its inputs and under ``torch.func``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _div(num, den):
    den = torch.where(den.abs() > _EPS, den,
                      torch.where(den >= 0, torch.full_like(den, _EPS), torch.full_like(den, -_EPS)))
    return num / den


def project(params, pts):
    """params (..., 6), pts (..., 3) in the camera frame -> (pixels (..., 2), valid)."""
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    d = torch.sqrt(torch.clamp(beta * (x * x + y * y) + z * z, min=0.0))
    den = alpha * d + (1.0 - alpha) * z
    w = torch.where(alpha <= 0.5, _div(alpha, 1.0 - alpha), _div(1.0 - alpha, alpha))
    valid = (z > -w * d) & (den > _EPS)
    return torch.stack([fx * _div(x, den) + cx, fy * _div(y, den) + cy], -1), valid


def unproject(params, pix):
    """params (6,), pix (..., 2) -> (rays (..., 3), valid)."""
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    mx = _div(pix[..., 0] - cx, fx)
    my = _div(pix[..., 1] - cy, fy)
    r2 = mx * mx + my * my
    inner = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    mz = _div(1.0 - beta * alpha * alpha * r2,
              alpha * torch.sqrt(torch.clamp(inner, min=0.0)) + (1.0 - alpha))
    valid = torch.where(alpha > 0.5, inner >= 0.0, torch.ones_like(inner, dtype=torch.bool))
    return torch.stack([mx, my, mz], -1), valid & (mz > _EPS)


def rotation(rvec):
    """Axis-angle (..., 3) -> (..., 3, 3) by Rodrigues, with its Taylor
    series near 0 so that forward-mode derivatives stay finite there."""
    t2 = torch.sum(rvec * rvec, -1, keepdim=True)[..., None]
    small = t2 < 1e-9
    s2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(s2)
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(t)) / s2)
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def transform(rvec, tvec, pts):
    """Points (..., N, 3) through the pose (..., 3), (..., 3)."""
    return pts @ rotation(rvec).mT + tvec[..., None, :]
