"""Levenberg–Marquardt cores: dense small-problem LM and Schur-structured
single-camera bundle adjustment.

Port of ``ccrs_tpu/solve/lm.py``:

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

``ba_solve_multi`` is the joint multi-camera solve.  ``ba_solve_mixed`` and
``ba_solve_multi_mixed`` are the two-stage mixed-precision solvers: the
same bodies run once in float32 (the bulk descent, ``rtol=1e-6``) and once
in the caller's dtype (the polish, ``polish_rtol()``), optionally with
float32 Jacobians (``jac_f32``).  Every body takes its dtype from
``theta0``; TF32 is off for the whole package, so the float32 stage
multiplies in full float32.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from . import se3


def polish_rtol() -> float:
    """Relative-cost stop of the polish stage of the mixed solvers
    (``ba_solve_mixed``, ``ba_solve_multi_mixed``): 1e-10 unless
    ``CCRS_POLISH_RTOL`` overrides it ("1e-14" restores the
    deep-convergence stop of the plain solvers)."""
    return float(os.environ.get("CCRS_POLISH_RTOL", "1e-10"))


def _polish_jac_f32(default: bool, force_on: bool = True) -> bool:
    """The polish stage's ``jac_f32`` after ``CCRS_POLISH_JAC32``: "0"
    forces float64 Jacobians; "1" forces float32 ones where ``force_on``
    (the joint solvers; the single-camera solver only honours "0")."""
    env = os.environ.get("CCRS_POLISH_JAC32", "")
    if env == "0":
        return False
    if env == "1" and force_on:
        return True
    return default


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


#: ``torch.func``'s forward mode keeps its nesting depth and dual levels
#: process-global, so two threads inside ``jacfwd`` at once break each
#: other ("no level exists"); the speculative calibration runs solves on
#: threads of its own, so every Jacobian evaluation holds this lock
_JACOBIAN_LOCK = threading.Lock()


def _serialized(fn):
    """``fn`` called under the Jacobian lock."""
    def call(*args):
        with _JACOBIAN_LOCK:
            return fn(*args)
    return call


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


class _LMState:
    """The damping loop's scalars (lam, cost, the run of rejections, whether
    any step was accepted) and its verdict on each trial step.

    ``stall_lam``: a stall also needs lam to have climbed this far
    (``LMOptions.stall_lam``); 0 stalls on the rejection count alone, the
    rule of the JAX package's frame-sharded solvers."""

    def __init__(self, cost, opts: LMOptions, stall_lam: float):
        dev = cost.device
        self.opts = opts
        self.stall_lam = stall_lam
        self.lam = torch.tensor(opts.lam0, dtype=cost.dtype, device=dev)
        self.cost = cost
        self.rej = torch.zeros((), dtype=torch.int64, device=dev)
        self.acc_any = torch.zeros((), dtype=torch.bool, device=dev)
        self.it = 0

    def update(self, c_new, gsmall=None):
        """Accept the trial iff it lowers the cost; returns (accept, done).
        ``gsmall``: an extra convergence test (a vanished gradient)."""
        o = self.opts
        accept = c_new < self.cost
        self.lam = torch.clamp(
            torch.where(accept, self.lam * o.lam_down, self.lam * o.lam_up),
            o.lam_min, o.lam_max,
        )
        converged = accept & (
            self.cost - c_new <= o.rtol * torch.clamp(self.cost, min=1e-300)
        )
        if gsmall is not None:
            converged = converged | gsmall
        self.cost = torch.where(accept, c_new, self.cost)
        self.rej = torch.where(accept, torch.zeros_like(self.rej), self.rej + 1)
        self.acc_any = self.acc_any | accept
        limit = torch.where(self.acc_any, o.max_rejects, 3 * o.max_rejects)
        stall = (self.rej >= limit) & (self.lam >= self.stall_lam)
        self.it += 1
        return accept, bool(converged | stall)


# --------------------------------------------------------------------------
# frame shards: the BA bodies below run over an ordered device list
# --------------------------------------------------------------------------


def _split(x, devices, dim: int = 0):
    """Contiguous equal shards of ``x`` along ``dim``, shard i on
    devices[i] (one device: ``x`` itself)."""
    n = x.shape[dim]
    if n % len(devices):
        raise ValueError(f"{n} frames do not split over {len(devices)} shards")
    step = n // len(devices)
    return [x.narrow(dim, i * step, step).to(d) for i, d in enumerate(devices)]


def _reduce(parts, dev0):
    """Sum per-shard tensors on the first device, in shard order."""
    total = parts[0].to(dev0)
    for p in parts[1:]:
        total = total + p.to(dev0)
    return total


def _gather(parts, dev0):
    """Concatenate per-shard tensors on the first device."""
    return parts[0].to(dev0) if len(parts) == 1 else torch.cat([p.to(dev0) for p in parts])


class _PerDevice:
    """One copy of a replicated tensor per distinct device."""

    def __init__(self, x):
        self.x = x
        self.copies = {}

    def on(self, dev):
        key = str(dev)
        if key not in self.copies:
            self.copies[key] = self.x.to(dev)
        return self.copies[key]


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
    st = _LMState(cost_of(x), opts, opts.stall_lam)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    while st.it < opts.max_iters:
        J, (r, w) = _serialized(jacfwd(r_aux, has_aux=True))(x)  # J (B, d, n)
        r2 = torch.sum(r * r, dim=-1)
        wtot = w * huber_block_weight(r2, opts.huber_delta)
        Jm = J * free_m
        H = torch.einsum("bdi,bdj,b->ij", Jm, Jm, wtot)
        g = torch.einsum("bdi,bd,b->i", Jm, r, wtot)
        H = H + eye * (1.0 - free_m)  # unit diag for fixed -> step 0

        dx = cholesky_solve_batched_small(_damped(H, st.lam), -g)
        x_new = clamp(x + _finite_or_zero(dx) * free_m)
        accept, done = st.update(cost_of(x_new))
        x = torch.where(accept, x_new, x)
        if done:
            break
    return x, st.cost, st.it


# --------------------------------------------------------------------------
# Schur-structured single-camera bundle adjustment
# --------------------------------------------------------------------------


class BAResult(NamedTuple):
    theta: torch.Tensor  # (k,) reduced intrinsics
    poses: torch.Tensor  # (F, 6) rvec|tvec
    cost: torch.Tensor
    n_iters: int
    #: the polish stage's share of n_iters (mixed solvers only; 0 for a
    #: plain single-precision solve)
    n_polish: int = 0


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
    jac_f32: bool = False,
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
      jac_f32: evaluate the JACOBIANS in float32 (residuals, costs and
        the accept/convergence logic stay in the caller's dtype).
        Gauss-Newton with an approximate J converges to the fixed point
        of J~tWr = 0: a 1e-7-relative J error shifts the optimum by
        O(1e-7) in parameters and only to second order in RMS.  No
        effect on a float32 solve.

    All tensors share one device and dtype (float64 for the calibration).
    Replaces the reference's calib_camera solve (src/util.rs:384-490): the
    F*N reprojection factors become one fixed-shape residual tensor; the
    sparse normal equations a k x k Schur system plus F 6x6 solves.
    """
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)
    return ba_lm(project_fn, theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid,
                 [theta0.device], one_focal, opts, jac_f32=jac_f32)


def _with_aux(f):
    """``f`` returning its value twice, so ``jacfwd(has_aux=True)`` hands
    the residual back beside its Jacobians."""
    def r_aux(*args):
        r = f(*args)
        return r, r

    return r_aux


def _jacobians_f32(jac32, residuals):
    """Jacobians from ``jac32`` (built on float32 board points) at float32
    copies of the arguments, cast back to the arguments' dtype, beside the
    residual in that dtype: -> (Js, r) as the full-precision function."""
    f32 = torch.float32

    def jacobians(*args):
        Js, _ = jac32(*(a.to(f32) for a in args))
        return tuple(J.to(args[0].dtype) for J in Js), residuals(*args)

    return jacobians


def ba_frame_fns(project_fn, p3d, one_focal: bool, jac_f32: bool = False):
    """(residuals, jacobians) over a frame batch: ``residuals(theta, poses,
    p2d)`` (F, N, 2) and ``jacobians`` -> ((Jt, Jp), r), Jt (F, N, 2, k),
    Jp (F, N, 2, 6), under the Jacobian lock.  ``jac_f32``: the Jacobians
    come from the same residual body on float32 copies (see ``ba_solve``);
    ignored when ``p3d`` is float32 already."""

    def residual_with(pts):
        # ONE residual body for both precisions: the float32-Jacobian path
        # differentiates the same math on float32 points
        def frame_residual(theta, pose, p2d_f):
            params = expand_theta(theta, one_focal)
            pc = se3.transform(pose[:3], pose[3:], pts)
            proj, _ = project_fn(params, pc)
            return proj - p2d_f  # (N, 2)

        return frame_residual

    def jac_of(pts):
        return _serialized(vmap(
            jacfwd(_with_aux(residual_with(pts)), argnums=(0, 1), has_aux=True),
            in_dims=(None, 0, 0),
        ))

    residuals = vmap(residual_with(p3d), in_dims=(None, 0, 0))
    if jac_f32 and p3d.dtype != torch.float32:
        return residuals, _jacobians_f32(jac_of(p3d.to(torch.float32)), residuals)
    return residuals, jac_of(p3d)


def ba_step(jacs, theta, poses_s, p2d_s, w_s, valid_s, free, lam, devices,
            huber_delta, mesh_rules: bool = False):
    """One damped Schur step of the single-camera BA over frame shards.

    Per shard (shard s on ``devices[s]``, Jacobians ``jacs[s]`` from
    ``ba_frame_fns``): Huber-weighted normal blocks, one 6x6 solve per
    frame with k+1 stacked right-hand sides, and the partial Schur sums.
    Across shards: one reduction of the packed (U | Schur correction |
    rhs) system on the first device, where the k x k solve runs once.
    ``valid_s``: per-shard (F_s,) frame masks; None takes the frames that
    carry weight.  Invalid frames get an identity block and no update.

    ``mesh_rules``: a non-finite intrinsics step is zeroed before the
    poses' back-substitution, as in the JAX package's frame-sharded
    solvers; ``ba_solve`` back-substitutes the raw step, so such a step
    moves no pose either.

    Returns (dth (k,) with non-finite entries zeroed, the poses after the
    step per shard).
    """
    dev0 = devices[0]
    k = theta.shape[0]
    th, fr, lm = _PerDevice(theta), _PerDevice(free), _PerDevice(lam)
    packed, local = [], []
    for s, d in enumerate(devices):
        (Jt, Jp), r = jacs[s](th.on(d), poses_s[s], p2d_s[s])  # (F,N,2,k), (F,N,2,6)
        Jt = Jt * fr.on(d)
        r2 = torch.sum(r * r, dim=-1)
        wt = w_s[s] * huber_block_weight(r2, huber_delta)  # (F, N)
        valid = (torch.sum(wt, dim=1) > 0).to(wt.dtype) if valid_s is None else valid_s[s]

        U = torch.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)  # (k, k)
        A = torch.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)  # (F, 6, 6)
        B = torch.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)  # (F, k, 6)
        g_t = torch.einsum("fnri,fnr,fn->i", Jt, r, wt)  # (k,)
        g_p = torch.einsum("fnri,fnr,fn->fi", Jp, r, wt)  # (F, 6)

        eye6 = torch.eye(6, dtype=wt.dtype, device=d)
        Ad = torch.where(valid[:, None, None] > 0, _damped(A, lm.on(d)), eye6)
        sol = cholesky_solve_batched_small(Ad, torch.cat([B.mT, g_p[..., None]], dim=2))
        Ainv_Bt, Ainv_g = sol[..., :-1], sol[..., -1]  # (F, 6, k), (F, 6)
        corr = torch.einsum("fij,fjk->ik", B, Ainv_Bt)
        rhs = -(g_t - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
        packed.append(torch.cat([U, corr, rhs[None, :]], dim=0))
        local.append((Ainv_Bt, Ainv_g, valid))
    tot = _reduce(packed, dev0)
    U, corr, rhs = tot[:k], tot[k : 2 * k], tot[2 * k]
    # unit diagonal for fixed variables, Marquardt scaling, then the
    # correction
    S = _damped(U + torch.diag(1.0 - free), lam) - corr
    dth = cholesky_solve_batched_small(S, rhs)
    if mesh_rules:
        dth = _finite_or_zero(dth)
    dr = _PerDevice(dth)
    po_new = []
    for s, d in enumerate(devices):
        Ainv_Bt, Ainv_g, valid = local[s]
        dpo = -(Ainv_g + torch.einsum("fik,k->fi", Ainv_Bt, dr.on(d)))
        po_new.append(poses_s[s] + _finite_or_zero(dpo) * valid[:, None])
    return _finite_or_zero(dth), po_new


def ba_lm(project_fn, theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid,
          devices, one_focal: bool, opts: LMOptions, mesh_rules: bool = False,
          jac_f32: bool = False):
    """The single-camera LM (``ba_solve``'s arguments) with the frames split
    into contiguous shards over ``devices``: poses and observations stay
    on their shard, each iteration reduces one packed system (``ba_step``)
    and the robust cost on the first device.  F must be a multiple of
    ``len(devices)``; results on the first device.

    ``mesh_rules``: the JAX package's frame-sharded rules (``ba_step``'s
    step order, and a stall on the rejection count alone, whatever lam).
    ``jac_f32``: float32 Jacobians (see ``ba_solve``).
    """
    dev0 = devices[0]
    lo, hi, free = lo.to(dev0), hi.to(dev0), free.to(dev0)
    p3d_r = _PerDevice(p3d)
    fv_s = _split(frame_valid, devices)
    w_s = [ws * fv[:, None] for ws, fv in zip(_split(w, devices), fv_s)]
    p2d_s = _split(p2d, devices)
    fns = [ba_frame_fns(project_fn, p3d_r.on(d), one_focal, jac_f32) for d in devices]
    jacs = [jac for _, jac in fns]

    def cost_of(theta, poses_s):
        th = _PerDevice(theta)
        local = []
        for s, d in enumerate(devices):
            r = fns[s][0](th.on(d), poses_s[s], p2d_s[s])
            r2 = torch.sum(r * r, dim=-1)
            local.append(torch.sum(w_s[s] * huber_cost(r2, opts.huber_delta)))
        return _reduce(local, dev0)

    theta = torch.clamp(theta0.to(dev0), lo, hi)
    poses_s = _split(poses0, devices)
    st = _LMState(cost_of(theta, poses_s), opts, 0.0 if mesh_rules else opts.stall_lam)
    while st.it < opts.max_iters:
        dth, po_new = ba_step(jacs, theta, poses_s, p2d_s, w_s, fv_s, free, st.lam,
                              devices, opts.huber_delta, mesh_rules)
        th_new = torch.clamp(theta + dth * free, lo, hi)
        accept, done = st.update(cost_of(th_new, po_new))
        theta = torch.where(accept, th_new, theta)
        acc = _PerDevice(accept)
        poses_s = [torch.where(acc.on(d), pn, po)
                   for d, pn, po in zip(devices, po_new, poses_s)]
        if done:
            break
    return BAResult(theta, _gather(poses_s, dev0), st.cost, st.it)



def _as(dtype, *tensors):
    return [t.to(dtype) for t in tensors]


def ba_solve_mixed(
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
    polish_iters: int = 12,
    polish_jac_f32: bool = True,
) -> BAResult:
    """Two-stage mixed-precision single-camera BA: LM only needs full
    precision near the optimum.  Stage 1 runs the bulk descent in float32
    (``rtol=1e-6``, the float32 cost plateau); stage 2 polishes from that
    state in the caller's dtype for at most ``polish_iters`` iterations
    (stop: ``polish_rtol()``), with float32 JACOBIANS by default
    (residual, cost and accept stay in the caller's dtype — see
    ``ba_solve``'s ``jac_f32``; ``CCRS_POLISH_JAC32=0`` restores
    full-precision polish Jacobians).  ``n_iters`` counts both stages,
    ``n_polish`` the second."""
    polish_jac_f32 = _polish_jac_f32(polish_jac_f32, force_on=False)
    s1 = ba_solve(
        project_fn,
        *_as(torch.float32, theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid),
        one_focal=one_focal, max_iters=max_iters, huber_delta=huber_delta, rtol=1e-6,
    )
    dt = theta0.dtype
    s2 = ba_solve(
        project_fn, s1.theta.to(dt), s1.poses.to(dt), p3d, p2d, w, lo, hi, free,
        frame_valid, one_focal=one_focal, max_iters=polish_iters,
        huber_delta=huber_delta, rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )
    return BAResult(s2.theta, s2.poses, s2.cost, s1.n_iters + s2.n_iters, s2.n_iters)


# --------------------------------------------------------------------------
# multi-camera joint bundle adjustment
# --------------------------------------------------------------------------


class MultiBAResult(NamedTuple):
    theta: torch.Tensor  # (C, k)
    ext: torch.Tensor  # (C, 6) T_cam_i<-cam0 (row 0 pinned identity)
    poses: torch.Tensor  # (F, 6) board->cam0
    cost: torch.Tensor
    n_iters: int
    #: the polish stage's share of n_iters (mixed solvers only)
    n_polish: int = 0


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
    jac_f32: bool = False,
) -> MultiBAResult:
    """Joint multi-camera BA: per-camera intrinsics + camera extrinsics
    (T_i_0) + shared board poses (T_0_b per frame).

    Replaces ``calib_all_camera_with_extrinsics`` (src/util.rs:567-715):
    cam0 observations constrain (theta_0, T_0_b); cam i>0 observations
    constrain (theta_i, T_i_0, T_0_b) through the chained transform
    T_i_0 * T_0_b (the OtherCamReprojectionFactor, factors.rs:204-228).
    Board poses are Schur-eliminated (F independent 6x6 blocks); the
    reduced system is (C*k + 6C) dense, solved by Cholesky.

    One precision from the first iteration to the last (``theta0``'s);
    ``ba_solve_multi_mixed`` is the two-stage solve.

    Args:
      theta0: (C, k) reduced intrinsics per camera.
      ext0: (C, 6) extrinsics rvec|tvec; row 0 must be zeros (pinned).
      poses0: (F, 6) board->cam0 poses.
      p2d/w: (C, F, N, 2) observations and (C, F, N) weights.
      lo/hi/free: (C, k) per-camera bounds/free masks on theta.
      cam_frame_valid: (C, F) camera c contributes frame f.
      frame_valid: (F,) frame participates at all.
      jac_f32: float32 Jacobians, residual and cost in the caller's dtype
        (see ``ba_solve``).
    """
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)
    return multi_ba_lm(project_fn, theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
                       cam_frame_valid, frame_valid, [theta0.device], one_focal, opts,
                       jac_f32=jac_f32)


def multi_frame_fns(project_fn, p3d, one_focal: bool, C: int, jac_f32: bool = False):
    """Per camera (residuals, jacobians) over a frame batch, each taking
    (theta_c, e_c, poses, p2d_c); jacobians -> ((Jt, Je, Jp), r).
    ``jac_f32``: as in ``ba_frame_fns``."""

    def residuals_with(pts):
        # single residual bodies for both precisions (see ba_frame_fns)
        def cam0_residual(theta_c, e_c, pose_f, p2d_cf):
            params = expand_theta(theta_c, one_focal)
            pc = se3.transform(pose_f[:3], pose_f[3:], pts)
            proj, _ = project_fn(params, pc)
            return proj - p2d_cf

        def cam_i_residual(theta_c, e_c, pose_f, p2d_cf):
            params = expand_theta(theta_c, one_focal)
            rvc, tvc = se3.compose(e_c[:3], e_c[3:], pose_f[:3], pose_f[3:])
            pc = se3.transform(rvc, tvc, pts)
            proj, _ = project_fn(params, pc)
            return proj - p2d_cf

        # the camera split is static: cam 0 sees the board pose directly,
        # cams >= 1 through their extrinsic (a Python-level choice, never
        # a data-dependent branch)
        return [cam0_residual] + [cam_i_residual] * (C - 1)

    def jacs_of(pts):
        return [
            _serialized(vmap(jacfwd(_with_aux(f), argnums=(0, 1, 2), has_aux=True),
                             in_dims=(None, None, 0, 0)))
            for f in residuals_with(pts)
        ]

    residuals = [vmap(f, in_dims=(None, None, 0, 0)) for f in residuals_with(p3d)]
    if jac_f32 and p3d.dtype != torch.float32:
        jacobians = [_jacobians_f32(j, r)
                     for j, r in zip(jacs_of(p3d.to(torch.float32)), residuals)]
    else:
        jacobians = jacs_of(p3d)
    return list(zip(residuals, jacobians))


def _multi_shard_blocks(fns, theta, ext, poses, p2d, w, free, ext_free, huber_delta):
    """One shard's joint normal blocks over its F_s frames: U (M, M), g_x
    (M,) and the board-pose blocks A (F_s, 6, 6), B (F_s, M, 6), g_p
    (F_s, 6), M = C*k + 6C (intrinsics, then extrinsics)."""
    C, k = theta.shape
    M = C * k + C * 6
    Floc = poses.shape[0]
    dtype, dev = theta.dtype, theta.device
    U = torch.zeros((M, M), dtype=dtype, device=dev)
    g_x = torch.zeros((M,), dtype=dtype, device=dev)
    A = torch.zeros((Floc, 6, 6), dtype=dtype, device=dev)
    B = torch.zeros((Floc, M, 6), dtype=dtype, device=dev)
    g_p = torch.zeros((Floc, 6), dtype=dtype, device=dev)
    for c in range(C):
        (Jt, Je, Jp), r = fns[c][1](theta[c], ext[c], poses, p2d[c])
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
    return U, g_x, A, B, g_p


def multi_ba_lm(project_fn, theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
                cam_frame_valid, frame_valid, devices, one_focal: bool,
                opts: LMOptions, mesh_rules: bool = False, jac_f32: bool = False):
    """The joint multi-camera LM (``ba_solve_multi``'s arguments) with the
    frames split into contiguous shards over ``devices``: board poses stay
    on their shard and are Schur-eliminated there; each iteration reduces
    one packed (U | Schur correction | rhs | gradient) system of size
    (2M+2, M) and the robust cost on the first device, where the M x M
    solve runs once.  F must be a multiple of ``len(devices)`` (padding
    frames carry frame_valid = 0); results on the first device.

    ``mesh_rules``: stall on the rejection count alone, whatever lam (the
    JAX package's frame-sharded rule).  ``jac_f32``: float32 Jacobians
    (see ``ba_solve``).
    """
    C = p2d.shape[0]
    k = theta0.shape[1]
    dtype = theta0.dtype
    M = C * k + C * 6
    dev0 = devices[0]
    lo, hi, free = lo.to(dev0), hi.to(dev0), free.to(dev0)
    w = w * cam_frame_valid[:, :, None] * frame_valid[None, :, None]
    # e_0 is pinned to identity; its columns get a unit diagonal below
    ext_free = torch.cat(
        [torch.zeros((1, 6), dtype=dtype, device=dev0),
         torch.ones((C - 1, 6), dtype=dtype, device=dev0)], dim=0,
    )
    unit_fixed = torch.diag(1.0 - torch.cat([free.reshape(-1), ext_free.reshape(-1)]))
    p3d_r, free_r, ext_free_r = _PerDevice(p3d), _PerDevice(free), _PerDevice(ext_free)
    fv_s = _split(frame_valid, devices)
    p2d_s = _split(p2d, devices, dim=1)
    w_s = _split(w, devices, dim=1)
    fns = [multi_frame_fns(project_fn, p3d_r.on(d), one_focal, C, jac_f32) for d in devices]
    eye6 = [torch.eye(6, dtype=dtype, device=d) for d in devices]

    def cost_of(theta, ext, poses_s):
        th, ex = _PerDevice(theta), _PerDevice(ext)
        local = []
        for s, d in enumerate(devices):
            total = torch.zeros((), dtype=dtype, device=d)
            for c in range(C):
                r = fns[s][c][0](th.on(d)[c], ex.on(d)[c], poses_s[s], p2d_s[s][c])
                r2 = torch.sum(r * r, dim=-1)
                total = total + torch.sum(w_s[s][c] * huber_cost(r2, opts.huber_delta))
            local.append(total)
        return _reduce(local, dev0)

    theta = torch.clamp(theta0.to(dev0), lo, hi)
    ext = ext0.to(dev0)
    poses_s = _split(poses0, devices)
    st = _LMState(cost_of(theta, ext, poses_s), opts, 0.0 if mesh_rules else opts.stall_lam)
    while st.it < opts.max_iters:
        th, ex, lm = _PerDevice(theta), _PerDevice(ext), _PerDevice(st.lam)
        packed, local = [], []
        for s, d in enumerate(devices):
            U, g_x, A, B, g_p = _multi_shard_blocks(
                fns[s], th.on(d), ex.on(d), poses_s[s], p2d_s[s], w_s[s],
                free_r.on(d), ext_free_r.on(d), opts.huber_delta,
            )
            Ad = torch.where(fv_s[s][:, None, None] > 0, _damped(A, lm.on(d)), eye6[s])
            sol = cholesky_solve_batched_small(Ad, torch.cat([B.mT, g_p[..., None]], dim=2))
            Ainv_Bt, Ainv_g = sol[..., :-1], sol[..., -1]  # (F, 6, M), (F, 6)
            corr = torch.einsum("fij,fjk->ik", B, Ainv_Bt)
            rhs = -(g_x - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
            packed.append(torch.cat([U, corr, rhs[None, :], g_x[None, :]], dim=0))
            local.append((Ainv_Bt, Ainv_g))
        tot = _reduce(packed, dev0)
        U, corr, rhs, g_x = tot[:M], tot[M : 2 * M], tot[2 * M], tot[2 * M + 1]
        S = _damped(U + unit_fixed, st.lam) - corr
        # Jacobi-scale the reduced solve: parameter magnitudes span ~1e5
        # (focal vs distortion vs extrinsic rotation); D S D has a unit
        # diagonal and solves identically
        dg = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        Sn = S / dg[:, None] / dg[None, :]
        dx = cholesky_solve_batched_small(Sn, rhs / dg) / dg
        dxr = _PerDevice(dx)
        po_new = []
        for s, d in enumerate(devices):
            Ainv_Bt, Ainv_g = local[s]
            dpo = -(Ainv_g + torch.einsum("fim,m->fi", Ainv_Bt, dxr.on(d)))
            po_new.append(poses_s[s] + _finite_or_zero(dpo) * fv_s[s][:, None])
        dx = _finite_or_zero(dx)
        th_new = torch.clamp(theta + dx[: C * k].reshape(C, k) * free, lo, hi)
        ex_new = ext + dx[C * k :].reshape(C, 6) * ext_free
        # stop on a tiny relative decrease OR a vanished gradient (large
        # joint problems keep finding micro-improvements at the noise floor)
        gsmall = torch.max(torch.abs(g_x)) <= 1e-9 * torch.clamp(st.cost, min=1.0)
        accept, done = st.update(cost_of(th_new, ex_new, po_new), gsmall)
        theta = torch.where(accept, th_new, theta)
        ext = torch.where(accept, ex_new, ext)
        acc = _PerDevice(accept)
        poses_s = [torch.where(acc.on(d), pn, po)
                   for d, pn, po in zip(devices, po_new, poses_s)]
        if done:
            break
    return MultiBAResult(theta, ext, _gather(poses_s, dev0), st.cost, st.it)


def ba_solve_multi_mixed(
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
    polish_iters: int = 10,
    polish_jac_f32: bool = False,
) -> MultiBAResult:
    """Two-stage mixed-precision joint BA (``ba_solve_multi``'s arguments):
    stage 1 runs the bulk of the descent in float32 (loose ``rtol=1e-6``
    stop, the float32 cost plateau), stage 2 polishes from the float32
    state in the caller's dtype for at most ``polish_iters`` iterations.

    Unlike the single-camera ``ba_solve_mixed``, the polish keeps
    full-precision JACOBIANS by default: the joint reduced system of a
    many-camera rig is ill-conditioned enough that float32 Jacobian error
    can poison the step.  ``CCRS_POLISH_JAC32=1`` forces float32 polish
    Jacobians for experiments, ``=0`` forces them off.
    """
    polish_jac_f32 = _polish_jac_f32(polish_jac_f32)
    s1 = ba_solve_multi(
        project_fn,
        *_as(torch.float32, theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
             cam_frame_valid, frame_valid),
        one_focal=one_focal, max_iters=max_iters, huber_delta=huber_delta, rtol=1e-6,
    )
    dt = theta0.dtype
    s2 = ba_solve_multi(
        project_fn, s1.theta.to(dt), s1.ext.to(dt), s1.poses.to(dt),
        p3d, p2d, w, lo, hi, free, cam_frame_valid, frame_valid,
        one_focal=one_focal, max_iters=polish_iters, huber_delta=huber_delta,
        rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )
    return MultiBAResult(s2.theta, s2.ext, s2.poses, s2.cost,
                         s1.n_iters + s2.n_iters, s2.n_iters)
