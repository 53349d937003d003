"""Plain bundle adjustment: the reference calibration of one camera or of a rig.

Unknowns: each camera's EUCM intrinsics, each camera's pose against
camera 0 (camera 0 is the identity) and the board's pose in camera 0 per
frame.  Cost: the sum over observed corners of Huber(|r|^2, delta = 1 px),
r the reprojection error of the corner, as the program's calibration
states it.  Levenberg-Marquardt on the dense normal equations, Jacobi
scaled, Jacobians by forward-mode differentiation, started from the
ground truth the inputs were made from.  ``dtype`` float64 is the
reference; float32 is its control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap

from gen import camera

HUBER = 1.0
MAX_ITERS = 100


@dataclasses.dataclass
class Solution:
    theta: np.ndarray  # (C, 6)
    ext: np.ndarray  # (C, 6), row 0 the identity
    poses: np.ndarray  # (F, 6)
    rms: float
    iters: int


def _compose(a, b):
    """Pose a after pose b, as (R, t)."""
    return camera.rotation(a[:3]) @ camera.rotation(b[:3]), \
        camera.rotation(a[:3]) @ b[3:] + a[3:]


def _residual_fn(p3d, with_ext: bool):
    def res(q, obs):
        theta, pose = q[:6], q[-6:]
        if with_ext:
            R, t = _compose(q[6:12], pose)
        else:
            R, t = camera.rotation(pose[:3]), pose[3:]
        pr, _ = camera.project(theta, p3d @ R.mT + t)
        return pr - obs
    return res


def _huber(r2):
    return torch.where(r2 <= HUBER * HUBER, r2,
                       2.0 * HUBER * torch.sqrt(torch.clamp(r2, min=1e-300)) - HUBER * HUBER)


def _huber_weight(r2):
    return torch.where(r2 <= HUBER * HUBER, torch.ones_like(r2),
                       HUBER / torch.sqrt(torch.clamp(r2, min=1e-300)))


def solve(theta0, ext0, poses0, p3d, p2d, w, dtype=torch.float64, device="cpu") -> Solution:
    """theta0 (C, 6), ext0 (C, 6), poses0 (F, 6), p3d (N, 3), p2d (C, F, N, 2),
    w (C, F, N) 0/1; frames that no camera observes keep their start."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    C, F = p2d.shape[0], p2d.shape[1]
    P3, P2, W = t(p3d), t(p2d), t(w)
    n_int, n_ext = 6 * C, 6 * (C - 1)
    P = n_int + n_ext + 6 * F
    fns = [_residual_fn(P3, c > 0) for c in range(C)]
    jacs = [vmap(jacfwd(f), in_dims=(0, 0)) for f in fns]
    ress = [vmap(f, in_dims=(0, 0)) for f in fns]
    frames = torch.arange(F, device=device)
    idx = []
    for c in range(C):
        cols = [torch.arange(6 * c, 6 * c + 6, device=device).expand(F, 6)]
        if c:
            cols.append(torch.arange(n_int + 6 * (c - 1), n_int + 6 * c, device=device).expand(F, 6))
        cols.append(n_int + n_ext + 6 * frames[:, None] + torch.arange(6, device=device))
        idx.append(torch.cat(cols, 1))

    def packed(x, c):
        parts = [x[6 * c:6 * c + 6].expand(F, 6)]
        if c:
            parts.append(x[n_int + 6 * (c - 1):n_int + 6 * c].expand(F, 6))
        parts.append(x[n_int + n_ext:].reshape(F, 6))
        return torch.cat(parts, 1)

    def cost(x):
        total = torch.zeros((), dtype=dtype, device=device)
        for c in range(C):
            r = torch.where(W[c][..., None] > 0, ress[c](packed(x, c), P2[c]), 0.0)
            total = total + torch.sum(W[c] * _huber(torch.sum(r * r, -1)))
        return total

    x = torch.cat([t(theta0).reshape(-1), t(ext0)[1:].reshape(-1), t(poses0).reshape(-1)])
    c0 = cost(x)
    lam = 1e-6
    it = 0
    eye = torch.eye(P, dtype=dtype, device=device)
    for it in range(1, MAX_ITERS + 1):
        H = torch.zeros((P, P), dtype=dtype, device=device)
        g = torch.zeros(P, dtype=dtype, device=device)
        for c in range(C):
            q = packed(x, c)
            seen = W[c][..., None] > 0
            J = torch.where(seen[..., None], jacs[c](q, P2[c]), 0.0)  # (F, N, 2, k)
            r = torch.where(seen, ress[c](q, P2[c]), 0.0)
            wt = W[c] * _huber_weight(torch.sum(r * r, -1))
            blocks = torch.einsum("fnik,fn,fnil->fkl", J, wt, J)
            k = idx[c].shape[1]
            H.index_put_((idx[c][:, :, None].expand(F, k, k), idx[c][:, None, :].expand(F, k, k)),
                         blocks, accumulate=True)
            g.index_put_((idx[c],), torch.einsum("fnik,fn,fni->fk", J, wt, r), accumulate=True)
        d = torch.diagonal(H)
        free = d > 0
        D = torch.where(free, torch.sqrt(torch.where(free, d, torch.ones_like(d))), torch.ones_like(d))
        Hs = H / D[:, None] / D[None, :] + torch.diag((~free).to(dtype))
        gs = g / D
        while True:
            L, info = torch.linalg.cholesky_ex(Hs + lam * eye)
            if int(info) == 0:
                step = -torch.cholesky_solve(gs[:, None], L)[:, 0] / D
                c1 = cost(x + step)
                if bool(torch.isfinite(c1)) and bool(c1 < c0):
                    break
            lam *= 10.0
            if lam > 1e10:
                return _solution(x, C, F, n_int, n_ext, it, p3d, p2d, w)
        done = bool((c0 - c1) <= 1e-15 * c0)
        x, c0 = x + step, c1
        lam = max(lam * 0.1, 1e-12)
        if done:
            break
    return _solution(x, C, F, n_int, n_ext, it, p3d, p2d, w)


def _solution(x, C, F, n_int, n_ext, it, p3d, p2d, w) -> Solution:
    theta = x[:n_int].reshape(C, 6)
    ext = torch.cat([torch.zeros((1, 6), dtype=x.dtype, device=x.device),
                     x[n_int:n_int + n_ext].reshape(C - 1, 6)])
    poses = x[n_int + n_ext:].reshape(F, 6)
    theta, ext, poses = (a.double().cpu().numpy() for a in (theta, ext, poses))
    return Solution(theta, ext, poses, rms(theta, ext, poses, p3d, p2d, w), it)


def rms(theta, ext, poses, p3d, p2d, w, device="cpu") -> float:
    """Reprojection RMS per axis in px, in float64, of any solution."""
    f64 = torch.float64
    P3 = torch.as_tensor(np.asarray(p3d, np.float64), device=device)
    num = den = 0.0
    for c in range(p2d.shape[0]):
        T = torch.as_tensor(np.asarray(poses, np.float64), device=device)
        if c:
            e = torch.as_tensor(np.asarray(ext[c], np.float64), device=device)
            R = camera.rotation(e[:3]) @ camera.rotation(T[:, :3])
            tt = (camera.rotation(e[:3]) @ T[:, 3:, None])[..., 0] + e[3:]
        else:
            R, tt = camera.rotation(T[:, :3]), T[:, 3:]
        pr, _ = camera.project(torch.as_tensor(np.asarray(theta[c], np.float64), device=device),
                               P3 @ R.mT + tt[:, None, :])
        wc = torch.as_tensor(w[c], dtype=f64, device=device)
        r2 = torch.where(wc > 0, torch.sum(
            (pr - torch.as_tensor(p2d[c], dtype=f64, device=device)) ** 2, -1), 0.0)
        num += float(torch.sum(wc * r2))
        den += float(torch.sum(wc))
    return float(np.sqrt(num / (2.0 * max(den, 1.0))))
