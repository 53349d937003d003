"""Levenberg–Marquardt cores: dense small-problem LM and Schur-structured
single-camera bundle adjustment.

Port of the float64 part of ``ccrs_tpu/solve/lm.py``:

- parameters are fixed-shape tensors — intrinsics ``theta`` plus a
  ``(F, 6)`` pose batch; variable frame and corner counts are weight masks;
- Jacobians come from ``torch.func.jacfwd`` (forward mode: residual blocks
  are 2-dim and parameter blocks tiny), vmapped over frames;
- Huber robustness by IRLS row re-weighting;
- box bounds by step projection, fixed variables by Jacobian column masking
  plus a unit diagonal;
- the BA normal equations use the Schur complement over the pose blocks:
  F independent 6x6 Cholesky solves and one k x k reduced system.

The damping loop is a Python loop; each iteration reads its stop flag back
to the host once.  Cholesky factorizations of matrices that are not
positive definite yield NaN (``cholesky_nan``), as ``jnp.linalg.cholesky``
does, and the LM rejects such steps through its finiteness guard.

``ba_solve_multi`` is the joint multi-camera solve.  The mixed-precision
solvers of the JAX package (``ba_solve_mixed``, ``ba_solve_multi_mixed``)
are not ported (ROADMAP A.8): their float32 stage exists for the TPU's
emulated float64, and the port solves in float64 throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from . import se3


@dataclasses.dataclass(frozen=True)
class LMOptions:
    max_iters: int = 60
    lam0: float = 1e-6
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-12
    lam_max: float = 1e10
    rtol: float = 1e-14  # relative cost decrease
    huber_delta: Optional[float] = 1.0  # None = plain L2
    #: stall exit after this many consecutive rejections once a step was
    #: accepted (3x as many before any accept), and only once lam has
    #: climbed to ``stall_lam`` (see the JAX package's LMOptions)
    max_rejects: int = 5
    stall_lam: float = 1e2


def cholesky_nan(M):
    """Lower Cholesky factor of (..., n, n); batch elements that are not
    positive definite come back as NaN instead of raising."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def cho_solve(L, b):
    """Solve (L L^T) x = b for b of shape (..., n) or (..., n, m)."""
    vec = b.ndim == L.ndim - 1
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return x[..., 0] if vec else x


def cholesky_solve_batched_small(M, rhs):
    """Batched SPD solve M x = rhs, M (..., n, n), rhs (..., n) or
    (..., n, m); non-PD batch elements come back NaN."""
    return cho_solve(cholesky_nan(M), rhs)


def huber_block_weight(r2, delta):
    """IRLS weight for a residual block with squared norm r2.

    Huber rho(s) = s (s<=d^2), 2 d sqrt(s) - d^2 otherwise; weight rho'(s).
    """
    if delta is None:
        return torch.ones_like(r2)
    d2 = delta * delta
    return torch.where(
        r2 <= d2, torch.ones_like(r2),
        delta / torch.sqrt(torch.clamp(r2, min=1e-300)),
    )


def huber_cost(r2, delta):
    if delta is None:
        return r2
    d2 = delta * delta
    return torch.where(
        r2 <= d2, r2, 2.0 * delta * torch.sqrt(torch.clamp(r2, min=1e-300)) - d2
    )


def _damped(M, lam):
    """M + lam * diag(max(diag(M), 1e-12)), batched over leading dims."""
    d = torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=1e-12)
    return M + lam * torch.diag_embed(d)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# generic dense LM (convert_model and other small problems)
# --------------------------------------------------------------------------


def lm_solve(
    residual_fn: Callable,
    x0,
    *,
    lo=None,
    hi=None,
    free=None,
    opts: LMOptions = LMOptions(),
):
    """Dense LM over a flat parameter vector ``x0`` (n,).

    ``residual_fn(x) -> (blocks, w)``: residual blocks ``(B, d)`` and
    per-block weights ``(B,)`` (0 masks a block).  Huber is applied per
    block.  Returns (x, final_cost, n_iters).
    """
    n = x0.shape[0]
    free_m = torch.ones_like(x0) if free is None else free.to(x0.dtype)

    def clamp(x):
        if lo is not None:
            x = torch.maximum(x, lo)
        if hi is not None:
            x = torch.minimum(x, hi)
        return x

    def cost_of(x):
        r, w = residual_fn(x)
        r2 = torch.sum(r * r, dim=-1)
        return torch.sum(w * huber_cost(r2, opts.huber_delta))

    def r_aux(x):
        r, w = residual_fn(x)
        return r, (r, w)

    x = clamp(x0)
    lam = torch.tensor(opts.lam0, dtype=x0.dtype, device=x0.device)
    cost = cost_of(x)
    rej = torch.zeros((), dtype=torch.int64, device=x0.device)
    acc_any = torch.zeros((), dtype=torch.bool, device=x0.device)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    it = 0
    while it < opts.max_iters:
        J, (r, w) = jacfwd(r_aux, has_aux=True)(x)  # J (B, d, n)
        r2 = torch.sum(r * r, dim=-1)
        wtot = w * huber_block_weight(r2, opts.huber_delta)
        Jm = J * free_m
        H = torch.einsum("bdi,bdj,b->ij", Jm, Jm, wtot)
        g = torch.einsum("bdi,bd,b->i", Jm, r, wtot)
        H = H + eye * (1.0 - free_m)  # unit diag for fixed -> step 0

        dx = cholesky_solve_batched_small(_damped(H, lam), -g)
        x_new = clamp(x + _finite_or_zero(dx) * free_m)
        c_new = cost_of(x_new)
        accept = c_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.clamp(
            torch.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min, opts.lam_max,
        )
        converged = accept & (
            cost - c_new <= opts.rtol * torch.clamp(cost, min=1e-300)
        )
        cost = torch.where(accept, c_new, cost)
        rej = torch.where(accept, torch.zeros_like(rej), rej + 1)
        acc_any = acc_any | accept
        limit = torch.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)
        stall = (rej >= limit) & (lam >= opts.stall_lam)
        it += 1
        if bool(converged | stall):
            break
    return x, cost, it


# --------------------------------------------------------------------------
# Schur-structured single-camera bundle adjustment
# --------------------------------------------------------------------------


class BAResult(NamedTuple):
    theta: torch.Tensor  # (k,) reduced intrinsics
    poses: torch.Tensor  # (F, 6) rvec|tvec
    cost: torch.Tensor
    n_iters: int


def expand_theta(theta, one_focal: bool):
    """Reduced intrinsics -> full model params (re-insert fy = fx,
    mirroring src/optimization/factors.rs:155-158)."""
    if one_focal:
        return torch.cat([theta[:1], theta[:1], theta[1:]])
    return theta


def reduce_params(params, one_focal: bool):
    if one_focal:
        return torch.cat([params[:1], params[2:]])
    return params


def ba_solve(
    project_fn,
    theta0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    rtol: float = 1e-14,
) -> BAResult:
    """Single-camera BA: intrinsics + per-frame board poses.

    Args:
      project_fn: model projection ``(params, p3d) -> (p2d, valid)``.
      theta0: (k,) reduced intrinsics (fy removed when one_focal).
      poses0: (F, 6) initial rvec|tvec per frame.
      p3d: (N, 3) board points (shared across frames).
      p2d: (F, N, 2) observations (padded).
      w: (F, N) observation weights (0 = padding / unobserved corner).
      lo, hi, free: (k,) bounds and free-mask on theta.
      frame_valid: (F,) 0/1 — frames excluded from the problem entirely
        (the reference skips frames with <10 valid pose-init points,
        src/util.rs:431).

    All tensors share one device and dtype (float64 for the calibration).
    Replaces the reference's calib_camera solve (src/util.rs:384-490): the
    F*N reprojection factors become one fixed-shape residual tensor; the
    sparse normal equations a k x k Schur system plus F 6x6 solves.
    """
    dtype, dev = theta0.dtype, theta0.device
    w = w * frame_valid[:, None]
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)

    def frame_residual(theta, pose, p2d_f):
        params = expand_theta(theta, one_focal)
        pc = se3.transform(pose[:3], pose[3:], p3d)
        proj, _ = project_fn(params, pc)
        return proj - p2d_f  # (N, 2)

    def r_aux(theta, pose, p2d_f):
        r = frame_residual(theta, pose, p2d_f)
        return r, r

    residuals = vmap(frame_residual, in_dims=(None, 0, 0))
    jacobians = vmap(
        jacfwd(r_aux, argnums=(0, 1), has_aux=True), in_dims=(None, 0, 0)
    )

    def cost_of(theta, poses):
        r = residuals(theta, poses, p2d)
        r2 = torch.sum(r * r, dim=-1)
        return torch.sum(w * huber_cost(r2, huber_delta))

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    fv = frame_valid[:, None, None] > 0

    theta = torch.clamp(theta0, lo, hi)
    poses = poses0
    lam = torch.tensor(opts.lam0, dtype=dtype, device=dev)
    cost = cost_of(theta, poses)
    rej = torch.zeros((), dtype=torch.int64, device=dev)
    acc_any = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters:
        (Jt, Jp), r = jacobians(theta, poses, p2d)  # (F,N,2,k), (F,N,2,6)
        Jt = Jt * free
        r2 = torch.sum(r * r, dim=-1)
        wt = w * huber_block_weight(r2, huber_delta)  # (F, N)

        U = torch.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)  # (k, k)
        A = torch.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)  # (F, 6, 6)
        B = torch.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)  # (F, k, 6)
        g_t = torch.einsum("fnri,fnr,fn->i", Jt, r, wt)  # (k,)
        g_p = torch.einsum("fnri,fnr,fn->fi", Jp, r, wt)  # (F, 6)
        U = U + torch.diag(1.0 - free)

        Ud = _damped(U, lam)
        # empty frames get an identity block (their step is forced to 0)
        Ad = torch.where(fv, _damped(A, lam), eye6)
        # one 6x6 solve per frame with k+1 stacked right-hand sides
        sol = cholesky_solve_batched_small(
            Ad, torch.cat([B.mT, g_p[..., None]], dim=2)
        )
        Ainv_Bt = sol[..., :-1]  # (F, 6, k)
        Ainv_g = sol[..., -1]  # (F, 6)
        S = Ud - torch.einsum("fij,fjk->ik", B, Ainv_Bt)
        rhs = -(g_t - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
        dth = cholesky_solve_batched_small(S, rhs)
        dpo = -(Ainv_g + torch.einsum("fik,k->fi", Ainv_Bt, dth))
        th_new = torch.clamp(theta + _finite_or_zero(dth) * free, lo, hi)
        po_new = poses + _finite_or_zero(dpo) * frame_valid[:, None]

        c_new = cost_of(th_new, po_new)
        accept = c_new < cost
        theta = torch.where(accept, th_new, theta)
        poses = torch.where(accept, po_new, poses)
        lam = torch.clamp(
            torch.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min, opts.lam_max,
        )
        converged = accept & (
            cost - c_new <= opts.rtol * torch.clamp(cost, min=1e-300)
        )
        cost = torch.where(accept, c_new, cost)
        rej = torch.where(accept, torch.zeros_like(rej), rej + 1)
        acc_any = acc_any | accept
        limit = torch.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)
        stall = (rej >= limit) & (lam >= opts.stall_lam)
        it += 1
        if bool(converged | stall):
            break
    return BAResult(theta, poses, cost, it)


# --------------------------------------------------------------------------
# multi-camera joint bundle adjustment
# --------------------------------------------------------------------------


class MultiBAResult(NamedTuple):
    theta: torch.Tensor  # (C, k)
    ext: torch.Tensor  # (C, 6) T_cam_i<-cam0 (row 0 pinned identity)
    poses: torch.Tensor  # (F, 6) board->cam0
    cost: torch.Tensor
    n_iters: int


def ba_solve_multi(
    project_fn,
    theta0,
    ext0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    cam_frame_valid,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    rtol: float = 1e-14,
) -> MultiBAResult:
    """Joint multi-camera BA: per-camera intrinsics + camera extrinsics
    (T_i_0) + shared board poses (T_0_b per frame).

    Replaces ``calib_all_camera_with_extrinsics`` (src/util.rs:567-715):
    cam0 observations constrain (theta_0, T_0_b); cam i>0 observations
    constrain (theta_i, T_i_0, T_0_b) through the chained transform
    T_i_0 * T_0_b (the OtherCamReprojectionFactor, factors.rs:204-228).
    Board poses are Schur-eliminated (F independent 6x6 blocks); the
    reduced system is (C*k + 6C) dense, solved by Cholesky.

    The port solves in float64 from the first iteration, where
    ``ccrs_tpu`` runs ``ba_solve_multi_mixed`` (a float32 descent, then a
    float64 polish); both stop at the same float64 optimum.

    Args:
      theta0: (C, k) reduced intrinsics per camera.
      ext0: (C, 6) extrinsics rvec|tvec; row 0 must be zeros (pinned).
      poses0: (F, 6) board->cam0 poses.
      p2d/w: (C, F, N, 2) observations and (C, F, N) weights.
      lo/hi/free: (C, k) per-camera bounds/free masks on theta.
      cam_frame_valid: (C, F) camera c contributes frame f.
      frame_valid: (F,) frame participates at all.
    """
    C, F, N, _ = p2d.shape
    k = theta0.shape[1]
    dtype, dev = theta0.dtype, theta0.device
    M = C * k + C * 6
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)
    w = w * cam_frame_valid[:, :, None] * frame_valid[None, :, None]

    # e_0 is pinned to identity; its columns get a unit diagonal below
    ext_free = torch.cat(
        [torch.zeros((1, 6), dtype=dtype, device=dev),
         torch.ones((C - 1, 6), dtype=dtype, device=dev)], dim=0,
    )

    def cam0_residual(theta_c, e_c, pose_f, p2d_cf):
        params = expand_theta(theta_c, one_focal)
        pc = se3.transform(pose_f[:3], pose_f[3:], p3d)
        proj, _ = project_fn(params, pc)
        return proj - p2d_cf

    def cam_i_residual(theta_c, e_c, pose_f, p2d_cf):
        params = expand_theta(theta_c, one_focal)
        rvc, tvc = se3.compose(e_c[:3], e_c[3:], pose_f[:3], pose_f[3:])
        pc = se3.transform(rvc, tvc, p3d)
        proj, _ = project_fn(params, pc)
        return proj - p2d_cf

    def with_aux(f):
        def r_aux(*args):
            r = f(*args)
            return r, r

        return r_aux

    # the camera split is static: cam 0 sees the board pose directly, cams
    # >= 1 through their extrinsic (a Python-level choice, never a
    # data-dependent branch)
    fns = [cam0_residual] + [cam_i_residual] * (C - 1)
    residuals = [vmap(f, in_dims=(None, None, 0, 0)) for f in fns]
    jacobians = [
        vmap(jacfwd(with_aux(f), argnums=(0, 1, 2), has_aux=True),
             in_dims=(None, None, 0, 0))
        for f in fns
    ]

    def cost_of(theta, ext, poses):
        total = torch.zeros((), dtype=dtype, device=dev)
        for c in range(C):
            r = residuals[c](theta[c], ext[c], poses, p2d[c])
            r2 = torch.sum(r * r, dim=-1)
            total = total + torch.sum(w[c] * huber_cost(r2, huber_delta))
        return total

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    fv = frame_valid[:, None, None] > 0
    full_free = torch.cat([free.reshape(-1), ext_free.reshape(-1)])
    unit_fixed = torch.diag(1.0 - full_free)

    theta = torch.clamp(theta0, lo, hi)
    ext = ext0
    poses = poses0
    lam = torch.tensor(opts.lam0, dtype=dtype, device=dev)
    cost = cost_of(theta, ext, poses)
    rej = torch.zeros((), dtype=torch.int64, device=dev)
    acc_any = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters:
        U = torch.zeros((M, M), dtype=dtype, device=dev)
        g_x = torch.zeros((M,), dtype=dtype, device=dev)
        A = torch.zeros((F, 6, 6), dtype=dtype, device=dev)
        B = torch.zeros((F, M, 6), dtype=dtype, device=dev)
        g_p = torch.zeros((F, 6), dtype=dtype, device=dev)
        for c in range(C):
            (Jt, Je, Jp), r = jacobians[c](theta[c], ext[c], poses, p2d[c])
            Jt = Jt * free[c]
            Je = Je * ext_free[c]
            r2 = torch.sum(r * r, dim=-1)
            wt = w[c] * huber_block_weight(r2, huber_delta)  # (F, N)

            ti = c * k
            ei = C * k + c * 6
            Ute = torch.einsum("fnri,fnrj,fn->ij", Jt, Je, wt)
            U[ti : ti + k, ti : ti + k] += torch.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)
            U[ei : ei + 6, ei : ei + 6] += torch.einsum("fnri,fnrj,fn->ij", Je, Je, wt)
            U[ti : ti + k, ei : ei + 6] += Ute
            U[ei : ei + 6, ti : ti + k] += Ute.T
            g_x[ti : ti + k] += torch.einsum("fnri,fnr,fn->i", Jt, r, wt)
            g_x[ei : ei + 6] += torch.einsum("fnri,fnr,fn->i", Je, r, wt)
            A += torch.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)
            B[:, ti : ti + k, :] += torch.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)
            B[:, ei : ei + 6, :] += torch.einsum("fnri,fnrj,fn->fij", Je, Jp, wt)
            g_p += torch.einsum("fnri,fnr,fn->fi", Jp, r, wt)
        U = U + unit_fixed

        Ud = _damped(U, lam)
        Ad = torch.where(fv, _damped(A, lam), eye6)
        sol = cholesky_solve_batched_small(
            Ad, torch.cat([B.mT, g_p[..., None]], dim=2)
        )
        Ainv_Bt = sol[..., :-1]  # (F, 6, M)
        Ainv_g = sol[..., -1]
        S = Ud - torch.einsum("fij,fjk->ik", B, Ainv_Bt)
        rhs = -(g_x - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
        # Jacobi-scale the reduced solve: parameter magnitudes span ~1e5
        # (focal vs distortion vs extrinsic rotation); D S D has a unit
        # diagonal and solves identically
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        Sn = S / d[:, None] / d[None, :]
        dx = cholesky_solve_batched_small(Sn, rhs / d) / d
        dpo = -(Ainv_g + torch.einsum("fim,m->fi", Ainv_Bt, dx))
        dx = _finite_or_zero(dx)
        dpo = _finite_or_zero(dpo)
        th_new = torch.clamp(theta + dx[: C * k].reshape(C, k) * free, lo, hi)
        ex_new = ext + dx[C * k :].reshape(C, 6) * ext_free
        po_new = poses + dpo * frame_valid[:, None]

        c_new = cost_of(th_new, ex_new, po_new)
        accept = c_new < cost
        theta = torch.where(accept, th_new, theta)
        ext = torch.where(accept, ex_new, ext)
        poses = torch.where(accept, po_new, poses)
        lam = torch.clamp(
            torch.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min, opts.lam_max,
        )
        # stop on a tiny relative decrease OR a vanished gradient (large
        # joint problems keep finding micro-improvements at the noise floor)
        rel_small = cost - c_new <= opts.rtol * torch.clamp(cost, min=1e-300)
        gsmall = torch.max(torch.abs(g_x)) <= 1e-9 * torch.clamp(cost, min=1.0)
        converged = (accept & rel_small) | gsmall
        cost = torch.where(accept, c_new, cost)
        rej = torch.where(accept, torch.zeros_like(rej), rej + 1)
        acc_any = acc_any | accept
        limit = torch.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)
        stall = (rej >= limit) & (lam >= opts.stall_lam)
        it += 1
        if bool(converged | stall):
            break
    return MultiBAResult(theta, ext, poses, cost, it)
