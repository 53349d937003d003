"""Pose-from-correspondences (PnP) for planar calibration boards.

Port of ``ccrs_tpu/solve/pnp.py`` (the replacement of the reference's
``sqpnp_simple::sqpnp_solve_glam``, call sites ``src/optimization/
linear.rs:20`` and ``src/util.rs:436``).  Every caller passes AprilGrid
board points, which are coplanar (z=0):

1. DLT homography board(x,y) -> normalized image plane (9x9 normal matrix;
   null vector by Cholesky inverse iteration);
2. homography decomposition R = [h1' h2' h1'xh2'], t = h3/s, projected to
   SO(3) by the Newton polar iteration;
3. a fixed-iteration Gauss-Newton polish of the reprojection residual in
   the normalized plane (6x6 normal equations).

Every function is batched over leading dimensions (one pose per frame)
and takes per-point weights, so padded or invalid points are masked.
"""

from __future__ import annotations

import math

import torch

from . import se3
from .lm import cho_solve, cholesky_nan


def _weighted_normalize(p, w):
    """Shift+scale points for DLT conditioning. p (..., N, 2), w (..., N)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    mean = torch.sum(p * w[..., None], dim=-2) / wsum[..., None]
    d = torch.linalg.norm(p - mean[..., None, :], dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1) / wsum, min=1e-12)
    return mean, scale


def _smallest_eigvec(S, iters: int = 12):
    """Eigenvector of the smallest eigenvalue of symmetric PSD (..., n, n)
    matrices by shifted inverse iteration with Cholesky solves (the DLT
    spectrum has a well-separated near-null direction)."""
    n = S.shape[-1]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    # shift: small against the spectrum scale, above the dtype's rounding
    # noise, so the shifted matrix stays positive definite
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    eps = (tr / n) * (100.0 * torch.finfo(S.dtype).eps) + 1e-300
    L = cholesky_nan(S + eps[..., None, None] * eye)
    # deterministic start with overlap on any direction: ones + e0
    v = torch.ones(S.shape[:-1], dtype=S.dtype, device=S.device)
    v[..., 0] += 0.5
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        v = cho_solve(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-300)
    return v


def homography_dlt(p_src, p_dst, w):
    """Weighted DLT homography src->dst. p_src/p_dst (..., N, 2); w (..., N).

    Returns (..., 3, 3) H (h22 ~ 1 after denormalization).
    """
    ms, ss = _weighted_normalize(p_src, w)
    md, sd = _weighted_normalize(p_dst, w)
    s = (p_src - ms[..., None, :]) * ss[..., None, None]
    d = (p_dst - md[..., None, :]) * sd[..., None, None]
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2N, 9)
    h = _smallest_eigvec(A.mT @ A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalize: H = Td^-1 Hn Ts
    z, o = torch.zeros_like(ss), torch.ones_like(ss)
    Ts = torch.stack([
        torch.stack([ss, z, -ss * ms[..., 0]], -1),
        torch.stack([z, ss, -ss * ms[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    Td_inv = torch.stack([
        torch.stack([1.0 / sd, z, md[..., 0]], -1),
        torch.stack([z, 1.0 / sd, md[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    H = Td_inv @ Hn @ Ts
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() > 1e-12, h22, torch.ones_like(h22))


def _adjugate3(M):
    """Closed-form adjugate of (..., 3, 3) (adj(M) = det(M) * M^-1)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)


def _project_so3(Q, iters: int = 6):
    """Nearest rotation to Q by the Newton polar iteration
    ``Q <- (Q + Q^-T)/2`` (the caller guarantees det(Q) > 0)."""
    for _ in range(iters):
        det = torch.linalg.det(Q)
        det = torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
        Q = 0.5 * (Q + _adjugate3(Q).mT / det[..., None, None])
    return Q


def _pose_from_homography(H):
    """Zhang decomposition of a normalized-plane homography (K = I)."""
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    s = torch.sqrt(torch.linalg.norm(h1, dim=-1) * torch.linalg.norm(h2, dim=-1))
    s = torch.where(s > 1e-12, s, torch.ones_like(s))[..., None]
    # sign: the board must be in front of the camera (t_z > 0)
    sign = torch.where(h3[..., 2:3] >= 0, 1.0, -1.0).to(H.dtype)
    r1 = sign * h1 / s
    r2 = sign * h2 / s
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = _project_so3(torch.stack([r1, r2, r3], dim=-1))
    return R, sign * h3 / s


def _gn_polish(rvec, tvec, p3d, p2d, w, iters: int = 8):
    """Gauss-Newton on e_i = (x/z, y/z) - m_i with the analytic Jacobian.

    Left-multiplied rotation increment, additive translation; the rotation
    is carried as a matrix and converted to axis-angle once at the end (a
    per-iteration log/exp round trip is ill-conditioned near theta = pi,
    where the front-view board poses of this pipeline sit)."""
    R = se3.exp_so3(rvec)
    eye6 = torch.eye(6, dtype=p3d.dtype, device=p3d.device)
    for _ in range(iters):
        pc = p3d @ R.mT + tvec[..., None, :]
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zsafe = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
        e = torch.stack([x / zsafe, y / zsafe], -1) - p2d  # (..., N, 2)
        iz = 1.0 / zsafe
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        Jp = torch.stack([
            torch.stack([iz, zero, -x * iz2], -1),
            torch.stack([zero, iz, -y * iz2], -1),
        ], -2)  # d(proj)/d(pc): (..., N, 2, 3)
        # d(pc)/d(dw) = -[pc]_x ; d(pc)/d(dt) = I
        J = torch.cat([-Jp @ se3.hat(pc), Jp], dim=-1)  # (..., N, 2, 6)
        Jw = J * w[..., None, None]
        JtJ = torch.einsum("...nri,...nrj->...ij", Jw, J) + 1e-12 * eye6
        Jte = torch.einsum("...nri,...nr->...i", Jw, e)
        dx = cho_solve(cholesky_nan(JtJ), -Jte)
        dR = se3.exp_so3(dx[..., :3])
        R = dR @ R
        tvec = (dR @ tvec[..., None])[..., 0] + dx[..., 3:]
    return se3.log_so3(R), tvec


def solve_pnp_planar(p3d, p2d_norm, w=None):
    """Pose of a planar target from normalized-plane observations.

    Args:
      p3d: (..., N, 3) board points, z == 0 (the AprilGrid plane).
      p2d_norm: (..., N, 2) observations on the normalized image plane.
      w: optional (..., N) weights; 0 masks a point.

    Returns (rvec (..., 3), tvec (..., 3)) mapping board -> camera.
    """
    if w is None:
        w = torch.ones(p3d.shape[:-1], dtype=p3d.dtype, device=p3d.device)
    H = homography_dlt(p3d[..., :2], p2d_norm, w)
    R, t = _pose_from_homography(H)
    return _gn_polish(se3.log_so3(R), t, p3d, p2d_norm, w)


def solve_pnp_planar_batch(p3d, p2d_norm, w):
    """``solve_pnp_planar`` over a leading frame axis: (F, N, 3), (F, N, 2)
    and (F, N) give (rvec (F, 3), tvec (F, 3)).  The JAX package's name for
    its vmapped solver; ``solve_pnp_planar`` batches over leading axes
    itself."""
    return solve_pnp_planar(p3d, p2d_norm, w)
