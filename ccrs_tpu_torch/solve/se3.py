"""SE(3) / SO(3) primitives as torch functions.

Port of ``ccrs_tpu/solve/se3.py``: axis-angle exp/log, pose composition and
inverse, point transforms.  Batched over leading axes, dtype-polymorphic,
and safe under ``torch.func.jacfwd`` at the theta -> 0 singularity (Taylor
switch with the double-where trick).
"""

from __future__ import annotations

import torch

_SMALL = 1e-9


def _sinc_terms(theta2):
    """Return (sin(t)/t, (1-cos(t))/t^2, (t-sin(t))/t^3) gradient-safely.

    theta2 is theta^2 (avoids sqrt at 0).  Uses Taylor series below the
    switch point; exact forms above.
    """
    small = theta2 < _SMALL
    # safe theta2 for the exact branch
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    sin_t, cos_t = torch.sin(t), torch.cos(t)
    a_exact = sin_t / t
    b_exact = (1.0 - cos_t) / t2
    c_exact = (t - sin_t) / (t2 * t)
    a_taylor = 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0
    b_taylor = 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0
    a = torch.where(small, a_taylor, a_exact)
    b = torch.where(small, b_taylor, b_exact)
    c = torch.where(small, c_taylor, c_exact)
    return a, b, c


def hat(v):
    """(...,3) -> (...,3,3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], -1),
            torch.stack([z, o, -x], -1),
            torch.stack([-y, x, o], -1),
        ],
        -2,
    )


def _eye3(like):
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-2] + (3, 3))


def exp_so3(rvec):
    """Axis-angle (...,3) -> rotation matrix (...,3,3) via Rodrigues."""
    # per-rotation scalars keep a trailing axis of 1 here and in log_so3:
    # forward-mode AD gives a 0-dim float32 tensor times a Python float a
    # float64 tangent, which the matmuls downstream refuse
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    a, b, _ = _sinc_terms(theta2)
    K = hat(rvec)
    KK = K @ K
    return _eye3(K) + a[..., None] * K + b[..., None] * KK


def log_so3(R):
    """Rotation matrix (...,3,3) -> axis-angle (...,3).

    Smooth away from theta = pi; near pi uses the symmetric-part branch
    (nalgebra ``scaled_axis`` semantics, reference factors.rs:262).
    """
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]  # (..., 1)
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # arccos has infinite slope at +-1: clip its domain so jacfwd stays
    # finite at an exact identity, while the branch selection below keeps
    # values exact
    safe_cos = torch.clamp(cos_t, -1.0 + 1e-14, 1.0 - 1e-14)
    theta = torch.arccos(safe_cos)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    near_pi = torch.pi - theta < 1e-6
    # generic branch: theta / (2 sin theta) * w
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_t), sin_t)
    generic = w * (theta / (2.0 * safe_sin))
    # small: w/2 * (1 + theta^2/6), with theta^2 ~ 2(1-cos) (smooth in R)
    th2 = 2.0 * torch.clamp(1.0 - cos_t, min=0.0)
    small_branch = 0.5 * w * (1.0 + th2 / 6.0)
    # near pi: axis from diagonal of (R + I)/2
    A = (R + _eye3(R)) / 2.0
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], -1)
    axis_abs = torch.sqrt(torch.clamp(diag, min=0.0))
    # signs: largest axis component positive, the others from the
    # off-diagonals A_ij = a_i a_j
    off = torch.stack([A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]], -1)  # xy xz yz
    imax = torch.argmax(axis_abs, dim=-1)
    one = torch.ones_like(axis_abs[..., 0])
    sx = torch.where(
        imax == 0, one,
        torch.where(imax == 1, torch.sign(off[..., 0]), torch.sign(off[..., 1])),
    )
    sy = torch.where(
        imax == 0, torch.sign(off[..., 0]),
        torch.where(imax == 1, one, torch.sign(off[..., 2])),
    )
    sz = torch.where(
        imax == 0, torch.sign(off[..., 1]),
        torch.where(imax == 1, torch.sign(off[..., 2]), one),
    )
    sx = torch.where(sx == 0, one, sx)
    sy = torch.where(sy == 0, one, sy)
    sz = torch.where(sz == 0, one, sz)
    axis = axis_abs * torch.stack([sx, sy, sz], -1)
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(norm > 0, norm, torch.ones_like(norm))
    pi_branch = axis * theta
    return torch.where(
        small, small_branch,
        torch.where(near_pi, pi_branch, generic),
    )


def transform(rvec, tvec, pts):
    """Apply T=(R,t): (...,3),(...,3),(...,N,3) -> (...,N,3)."""
    R = exp_so3(rvec)
    return pts @ R.mT + tvec[..., None, :]


def compose(rvec_a, tvec_a, rvec_b, tvec_b):
    """T_a * T_b as (rvec,tvec)."""
    Ra = exp_so3(rvec_a)
    Rb = exp_so3(rvec_b)
    R = Ra @ Rb
    t = (Ra @ tvec_b[..., None])[..., 0] + tvec_a
    return log_so3(R), t


def inverse(rvec, tvec):
    R = exp_so3(rvec)
    Rt = R.mT
    return log_so3(Rt), -(Rt @ tvec[..., None])[..., 0]
