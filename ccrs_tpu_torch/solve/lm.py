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

The damping loop keeps its state on the solve's device, as the JAX
package's ``lax.while_loop`` does: the iterate, ``lam``, the cost, the run
of rejections, whether a step was accepted, the iteration count and the
stop flag are tensors, and one iteration is a pure body from that state to
the next one.  Once the stop flag is set (or ``max_iters`` is reached) the
body leaves every state tensor as it was, bit for bit, so a fixed chunk of
iterations runs a while-loop's iterations and counts only those.  On the
card (``graphs.active``) each solve captures two CUDA graphs per shape
(``graphs.py``): its start (clamp, first cost, fresh state) and a chunk of
``CHUNK_ITERS`` iterations that updates the state in place; the host
replays the chunk and reads the stop flag once per replay.  A solve whose
frame shards lie on several cards cuts each iteration at its two
reductions into per-shard and first-device phases, one captured graph per
device and phase, with the copies between the cards queued between the
replays: again one host read per ``CHUNK_ITERS`` iterations
(``_shard_loop``).  Elsewhere (the CPU, ``graphs.eager()``, the warm-up
thread's ``no_capture()``) the same bodies run eagerly, one iteration per
host read.  Results and ``n_iters`` are the same bits on every route
(``_route``).

Cholesky factorizations of matrices that are not positive definite yield
NaN (``cholesky_nan``), as ``jnp.linalg.cholesky`` does, and the LM
rejects such steps through its finiteness guard.  The solves behind them
are two triangular solves (cuBLAS on the card): the batched
``torch.cholesky_solve`` goes through MAGMA there, which a capture refuses.

``ba_solve_multi`` is the joint multi-camera solve.  ``ba_solve_mixed`` and
``ba_solve_multi_mixed`` are the two-stage mixed-precision solvers: the
same bodies run once in float32 (the bulk descent, ``rtol=1e-6``) and once
in the caller's dtype (the polish, ``polish_rtol()``), optionally with
float32 Jacobians (``jac_f32``).  Every body takes its dtype from
``theta0``; TF32 is off for the whole package, so the float32 stage
multiplies in full float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from .. import graphs
from . import se3

#: LM iterations per captured chunk on the card: the host reads the stop
#: flag once per replay, and a solve runs up to CHUNK_ITERS - 1 masked
#: iterations after its stop (chosen by measurement: PERF.md §6)
CHUNK_ITERS = 4


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
    """Solve (L L^T) x = b for b of shape (..., n) or (..., n, m), by two
    triangular solves (the same bits as ``torch.cholesky_solve`` on the
    CPU; on the card it captures, where the batched MAGMA route does not)."""
    vec = b.ndim == L.ndim - 1
    y = torch.linalg.solve_triangular(L, b[..., None] if vec else b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
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


def _lm_scalars(opts: LMOptions, cost):
    """The damping loop's fresh scalars beside the first ``cost``: lam,
    cost, the run of rejections, whether any step was accepted, the
    iteration count and the stop flag (set at once when max_iters <= 0)."""
    dev = cost.device
    return (
        torch.full((), opts.lam0, dtype=cost.dtype, device=dev), cost,
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.full((), opts.max_iters <= 0, dtype=torch.bool, device=dev),
    )


def _lm_update(opts: LMOptions, stall_lam: float, st, c_new, gsmall=None):
    """One verdict of the damping loop on a trial of cost ``c_new``, from
    the scalars ``st`` (``_lm_scalars``' order): accept iff it lowers the
    cost.  Returns (accept, next scalars).  ``gsmall``: an extra
    convergence test (a vanished gradient).

    ``stall_lam``: a stall also needs lam to have climbed this far
    (``LMOptions.stall_lam``); 0 stalls on the rejection count alone, the
    rule of the JAX package's frame-sharded solvers.

    Once the stop flag is set the iteration does not count: every scalar
    comes back as it was and ``accept`` is False, so the caller keeps its
    iterate too."""
    o = opts
    lam, cost, rej, acc_any, it, done = st
    run = ~done
    accept = c_new < cost
    lam_n = torch.clamp(
        torch.where(accept, lam * o.lam_down, lam * o.lam_up), o.lam_min, o.lam_max,
    )
    converged = accept & (cost - c_new <= o.rtol * torch.clamp(cost, min=1e-300))
    if gsmall is not None:
        converged = converged | gsmall
    rej_n = torch.where(accept, torch.zeros_like(rej), rej + 1)
    acc_n = acc_any | accept
    limit = torch.where(acc_n, o.max_rejects, 3 * o.max_rejects)
    stall = (rej_n >= limit) & (lam_n >= stall_lam)
    it_n = it + 1
    done_n = converged | stall | (it_n >= o.max_iters)
    nxt = (lam_n, torch.where(accept, c_new, cost), rej_n, acc_n, it_n, done_n)
    return accept & run, tuple(torch.where(run, n, s) for n, s in zip(nxt, st))


def _status(st):
    """(stop flag, iteration count) as one (2,) int64 tensor: the host's
    one read per chunk."""
    return torch.stack([st[5].to(torch.int64), st[4]])


def _write(buffers, values) -> None:
    for b, v in zip(buffers, values):
        b.copy_(v)


def _take(seq, *sizes):
    """``seq`` cut into consecutive pieces of these sizes, then the rest."""
    out, i = [], 0
    for n in sizes:
        out.append(list(seq[i : i + n]))
        i += n
    out.append(list(seq[i:]))
    return out


#: True inside a ``shard_graphs()`` block
_shard_forced = False


@contextlib.contextmanager
def shard_graphs(on: bool = True):
    """Inside the block every mesh of more than one shard takes the
    per-shard route (``_shard_loop``), also on one card and on the CPU
    (where ``graphs.get`` hands out eager stand-ins); ``on=False`` restores
    the route ``_route`` picks.  Process-wide, for tests and
    ``chip_smoke.py``; restored on exit, so blocks nest."""
    global _shard_forced
    before = _shard_forced
    _shard_forced = bool(on)
    try:
        yield
    finally:
        _shard_forced = before


def _route(devices) -> str:
    """How a solve over the shards ``devices`` runs its damping loop:
    "fused" when every shard lies on one device that takes graphs (one
    graph of ``CHUNK_ITERS`` iterations), "shards" when the shards lie on
    several such cards, or inside ``shard_graphs()`` (per-shard graphs,
    ``_shard_loop``), else "eager" (the same bodies, one host read per
    iteration)."""
    devs = {torch.empty(0, device=d).device for d in devices}
    if len(devices) > 1 and (_shard_forced or (
            len(devs) > 1 and all(graphs.active(d) for d in devs))):
        return "shards"
    if len(devs) == 1 and graphs.active(next(iter(devs))):
        return "fused"
    return "eager"


#: solves, chunks replayed or run (one host read each), iterations that
#: counted and masked iterations since ``reset_loop_counts`` (all
#: threads), and the solves per route
_loop_counts = {"solves": 0, "chunks": 0, "iters": 0, "masked": 0,
                "routes": {"fused": 0, "shards": 0, "eager": 0}}
_loop_lock = threading.Lock()


def loop_counts() -> dict:
    """The damping loops' solves, chunks (host reads: one per chunk on
    every route), iterations and the masked iterations after a stop, and
    the solves per route (``_route``), since the last
    ``reset_loop_counts``."""
    with _loop_lock:
        return dict(_loop_counts, routes=dict(_loop_counts["routes"]))


def reset_loop_counts() -> None:
    with _loop_lock:
        _loop_counts.update(solves=0, chunks=0, iters=0, masked=0,
                            routes={"fused": 0, "shards": 0, "eager": 0})


def _count_loop(route, chunks, it, n) -> None:
    with _loop_lock:
        _loop_counts["solves"] += 1
        _loop_counts["chunks"] += chunks
        _loop_counts["iters"] += it
        _loop_counts["masked"] += chunks * n - it
        _loop_counts["routes"][route] += 1


def _device_loop(name, start, chunk, static, problem, state, init, graphed: bool):
    """Run one LM to its stop and return (final state, n_iters).

    ``start(*static, *problem, *state, *init)`` writes the fresh state into
    ``state`` in place; ``chunk(*static, n, *problem, *state)`` runs n
    iterations in place and returns ``_status``.  ``state`` holds example
    values of the state (the capture's warm-up iterates from them).

    ``graphed`` (the "fused" route): the chunk is a captured graph of
    ``CHUNK_ITERS`` iterations whose buffers hold ``problem`` and the
    state, and the start a graph that writes that state; each replay of
    the chunk is one host read.  Otherwise ("eager") both run eagerly on
    stand-in buffers, one iteration per read.  Threads that solve at once
    take other instances (``graphs.lease``); the state is copied out
    before the lease ends.  The graphs are noted with ``graphs.keep``
    under ``name``, which bounds how many frame counts a long-lived
    process holds graphs for.  ``_shard_loop`` is the third route."""
    n = CHUNK_ITERS if graphed else 1
    scope = contextlib.nullcontext() if graphed else graphs.no_capture()
    with graphs.lease(name) as slot, scope:
        # the capture's warm-up runs one iteration, not a whole chunk
        steps = graphs.get(chunk, static + (n,), problem + state, slot=slot,
                           warm=static + (1,))
        np_ = len(problem)
        _write(steps.inputs[:np_], problem)
        first = graphs.get(start, static, init, bound=steps.inputs, slot=slot)
        _write(first.inputs, init)
        first.replay()
        chunks = 0
        while True:
            chunks += 1
            done, it = steps.replay().tolist()
            if done:
                break
        out = [t.clone() for t in steps.inputs[np_:]]
        graphs.keep(name, slot, (steps, first))
    _count_loop("fused" if graphed else "eager", chunks, it, n)
    return out, it


class _Phases(NamedTuple):
    """A frame-sharded LM's iteration cut at its reductions, each phase a
    pure function of one device's buffers (``_shard_loop``): on every
    shard ``system`` (commit the last accepted poses, Jacobians, pose
    solves, the packed partial) and ``trial`` (back-substitution, trial
    poses, local cost); on the first device ``solve`` (the partials summed
    in shard order, the reduced solve, the trial iterate: the step the
    shards read) and ``update`` (the costs summed, ``_lm_update``: the
    next iterate, lam and accept the shards read, and ``_status``).  The
    start: ``start`` on the first device (the clamped iterate and lam0),
    ``cost0`` on every shard, ``scalars`` on the first device."""

    start: Callable
    cost0: Callable
    scalars: Callable
    system: Callable
    solve: Callable
    trial: Callable
    update: Callable


def _shard_loop(name, phases, static, shards, first, n_written, n_written0, n_params):
    """The per-shard route of a frame-sharded LM (see ``_route``): run it
    to its stop and return (the iterate's tensors, the poses per shard,
    the final cost, n_iters).

    Each device's phases share the buffers of one holder graph: shard s's
    are ``shards[s]``, laid out as (the first ``n_written`` tensors the
    host writes, the poses last of them; the iterate, lam and accept it
    receives; the step it receives; its trial poses; its scratch), the
    first device's are ``first``: (the first ``n_written0`` tensors the
    host writes; the S packed partials and S costs it receives; the
    iterate (``n_params`` tensors) and the six scalars; its scratch).
    ``shards`` and ``first`` hold example values.  ``system`` and
    ``solve`` hold the buffers (``Graph.inputs``); every other phase binds
    them (``bound``).  On the card each phase is a captured graph of one
    device (one pool per device, solve name and slot: a device replays
    its phases one after another on its stream); the host queues
    ``CHUNK_ITERS`` iterations of replays and of the copies between them
    (``copy_`` into the receiving device's buffers, ordered on both
    devices' streams, no host wait), then reads the stop flag once.
    Elsewhere (the CPU, ``graphs.eager()``, ``no_capture()``) the same
    phases run eagerly on stand-ins.  Results are the eager route's bits:
    the phases run ``ba_step``'s and ``_multi_chunk``'s own helpers on the
    same values, and the partials and costs are summed in shard order.

    The poses of an accepted step are committed at the start of the next
    ``system`` (and once after the loop): once the stop flag is set every
    accept is False, so masked iterations change no bit of any state."""
    S = len(shards)
    with graphs.lease(name) as slot:
        pool = ("lm shards", name, slot)

        def get(fn, holder=(), bound=(), s=None):
            return graphs.get(fn, static, holder, bound=bound, slot=slot, pool=pool, tag=s)

        system = [get(phases.system, shards[s], s=s) for s in range(S)]
        held = [g.inputs for g in system]
        trial = [get(phases.trial, bound=held[s], s=s) for s in range(S)]
        cost0 = [get(phases.cost0, bound=held[s], s=s) for s in range(S)]
        solve = get(phases.solve, first)
        held0 = solve.inputs
        update, start, scalars = (get(f, bound=held0)
                                  for f in (phases.update, phases.start, phases.scalars))
        bcast, step = n_written, n_written + 1
        parts, costs = held0[n_written0 : n_written0 + S], held0[n_written0 + S : n_written0 + 2 * S]
        for h, values in zip(held, shards):
            _write(h[:n_written], values[:n_written])
        _write(held0[:n_written0], first[:n_written0])

        def broadcast(x, slot_):
            for h in held:
                h[slot_].copy_(x, non_blocking=True)

        broadcast(start.replay(), bcast)
        for s in range(S):
            costs[s].copy_(cost0[s].replay(), non_blocking=True)
        scalars.replay()
        chunks = 0
        while True:
            chunks += 1
            for _ in range(CHUNK_ITERS):
                for s in range(S):
                    parts[s].copy_(system[s].replay(), non_blocking=True)
                broadcast(solve.replay(), step)
                for s in range(S):
                    costs[s].copy_(trial[s].replay(), non_blocking=True)
                iterate, status = update.replay()
                broadcast(iterate, bcast)
            done, it = status.tolist()
            if done:
                break
        # commit the last accepted poses (a no-op after a masked iteration)
        poses = [torch.where(h[bcast][-1] > 0, h[n_written + 2], h[n_written - 1])
                 for h in held]
        # the iterate and the cost copied out in one piece
        state = held0[n_written0 + 2 * S : n_written0 + 2 * S + n_params + 2]
        flat = torch.cat([t.reshape(-1) for t in (*state[:n_params], state[-1])])
        params, i = [], 0
        for t in state[:n_params]:
            params.append(flat[i : i + t.numel()].view(t.shape))
            i += t.numel()
        by_device = {}
        for g in (*system, *trial, *cost0, solve, update, start, scalars):
            by_device.setdefault((g.inputs or g.bound)[0].device, []).append(g)
        for gs in by_device.values():
            graphs.keep(name + " shards", slot, gs)
    _count_loop("shards", chunks, it, CHUNK_ITERS)
    return params, poses, flat[-1], it


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
    data=(),
):
    """Dense LM over a flat parameter vector ``x0`` (n,).

    ``residual_fn(x, *data) -> (blocks, w)``: residual blocks ``(B, d)``
    and per-block weights ``(B,)`` (0 masks a block); ``data`` are the
    tensors it reads, which a captured loop holds in its buffers (so a
    module-level ``residual_fn`` serves every call of a shape with one
    graph).  Huber is applied per block.  Returns (x, final_cost, n_iters).
    """
    dt, dev = x0.dtype, x0.device
    free_m = torch.ones_like(x0) if free is None else free.to(dt)
    lo = torch.full_like(x0, -torch.inf) if lo is None else lo
    hi = torch.full_like(x0, torch.inf) if hi is None else hi
    data = tuple(data)
    static = (residual_fn, opts, len(data))
    example = (x0, *_lm_scalars(opts, torch.zeros((), dtype=dt, device=dev)))
    (x, _, cost, *_), n_iters = _device_loop(
        "lm", _lm_start, _lm_chunk, static, (lo, hi, free_m, *data), example, (x0,),
        graphed=graphs.active(dev),
    )
    return x, cost, n_iters


def _dense_cost(residual_fn, opts, x, data):
    r, w = residual_fn(x, *data)
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(w * huber_cost(r2, opts.huber_delta))


def _lm_start(residual_fn, opts, n_data, lo, hi, free_m, *rest):
    """``lm_solve``'s start: the clamped x0, its cost and fresh scalars,
    written into the state buffers."""
    data, state, (x0,) = _take(rest, n_data, 7)
    x = torch.minimum(torch.maximum(x0, lo), hi)
    _write(state, (x, *_lm_scalars(opts, _dense_cost(residual_fn, opts, x, data))))


def _lm_chunk(residual_fn, opts, n_data, n, lo, hi, free_m, *rest):
    """``n`` iterations of ``lm_solve``'s damping loop on the state
    buffers, in place; returns ``_status``."""
    data, state = _take(rest, n_data)
    x, st = state[0], tuple(state[1:])

    def r_aux(x):
        r, w = residual_fn(x, *data)
        return r, (r, w)

    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(n):
        J, (r, w) = _serialized(jacfwd(r_aux, has_aux=True))(x)  # J (B, d, n)
        r2 = torch.sum(r * r, dim=-1)
        wtot = w * huber_block_weight(r2, opts.huber_delta)
        Jm = J * free_m
        H = torch.einsum("bdi,bdj,b->ij", Jm, Jm, wtot)
        g = torch.einsum("bdi,bd,b->i", Jm, r, wtot)
        H = H + eye * (1.0 - free_m)  # unit diag for fixed -> step 0

        dx = cholesky_solve_batched_small(_damped(H, st[0]), -g)
        x_new = torch.minimum(torch.maximum(x + _finite_or_zero(dx) * free_m, lo), hi)
        accept, st = _lm_update(opts, opts.stall_lam, st,
                                _dense_cost(residual_fn, opts, x_new, data))
        x = torch.where(accept, x_new, x)
    _write(state, (x, *st))
    return _status(st)


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


def _ba_shard_system(jac, theta, poses, p2d, w, valid, free, lam, huber_delta):
    """One shard's share of a damped Schur step of the single-camera BA:
    Huber-weighted normal blocks, one 6x6 solve per frame with k+1 stacked
    right-hand sides and the partial Schur sums, all on the shard's device.
    ``valid``: the shard's (F_s,) frame mask, None for the frames that
    carry weight.  Returns (the packed (U | Schur correction | rhs)
    partial (2k+1, k), what the back-substitution needs: (Ainv_Bt,
    Ainv_g, valid))."""
    (Jt, Jp), r = jac(theta, poses, p2d)  # (F,N,2,k), (F,N,2,6)
    Jt = Jt * free
    r2 = torch.sum(r * r, dim=-1)
    wt = w * huber_block_weight(r2, huber_delta)  # (F, N)
    valid = (torch.sum(wt, dim=1) > 0).to(wt.dtype) if valid is None else valid

    U = torch.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)  # (k, k)
    A = torch.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)  # (F, 6, 6)
    B = torch.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)  # (F, k, 6)
    g_t = torch.einsum("fnri,fnr,fn->i", Jt, r, wt)  # (k,)
    g_p = torch.einsum("fnri,fnr,fn->fi", Jp, r, wt)  # (F, 6)

    eye6 = torch.eye(6, dtype=wt.dtype, device=wt.device)
    Ad = torch.where(valid[:, None, None] > 0, _damped(A, lam), eye6)
    sol = cholesky_solve_batched_small(Ad, torch.cat([B.mT, g_p[..., None]], dim=2))
    Ainv_Bt, Ainv_g = sol[..., :-1], sol[..., -1]  # (F, 6, k), (F, 6)
    corr = torch.einsum("fij,fjk->ik", B, Ainv_Bt)
    rhs = -(g_t - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
    return torch.cat([U, corr, rhs[None, :]], dim=0), (Ainv_Bt, Ainv_g, valid)


def _ba_reduced_step(tot, free, lam, mesh_rules: bool):
    """The k x k solve of the summed packed system ``tot``: (the step the
    poses back-substitute, the step with non-finite entries zeroed)."""
    k = tot.shape[1]
    U, corr, rhs = tot[:k], tot[k : 2 * k], tot[2 * k]
    # unit diagonal for fixed variables, Marquardt scaling, then the
    # correction
    S = _damped(U + torch.diag(1.0 - free), lam) - corr
    dth = cholesky_solve_batched_small(S, rhs)
    if mesh_rules:
        dth = _finite_or_zero(dth)
    return dth, _finite_or_zero(dth)


def _ba_backsub(local, dth, poses):
    """One shard's poses after the step ``dth`` (``_ba_shard_system``'s
    ``local``); frames that are not valid do not move."""
    Ainv_Bt, Ainv_g, valid = local
    dpo = -(Ainv_g + torch.einsum("fik,k->fi", Ainv_Bt, dth))
    return poses + _finite_or_zero(dpo) * valid[:, None]


def ba_step(jacs, theta, poses_s, p2d_s, w_s, valid_s, free, lam, devices,
            huber_delta, mesh_rules: bool = False):
    """One damped Schur step of the single-camera BA over frame shards.

    Per shard (shard s on ``devices[s]``, Jacobians ``jacs[s]`` from
    ``ba_frame_fns``): ``_ba_shard_system``.  Across shards: one reduction
    of the packed (U | Schur correction | rhs) system on the first device,
    where the k x k solve runs once.  ``valid_s``: per-shard (F_s,) frame
    masks; None takes the frames that carry weight.  Invalid frames get an
    identity block and no update.

    ``mesh_rules``: a non-finite intrinsics step is zeroed before the
    poses' back-substitution, as in the JAX package's frame-sharded
    solvers; ``ba_solve`` back-substitutes the raw step, so such a step
    moves no pose either.

    Returns (dth (k,) with non-finite entries zeroed, the poses after the
    step per shard).
    """
    th, fr, lm = _PerDevice(theta), _PerDevice(free), _PerDevice(lam)
    packed, local = [], []
    for s, d in enumerate(devices):
        p, loc = _ba_shard_system(jacs[s], th.on(d), poses_s[s], p2d_s[s], w_s[s],
                                  None if valid_s is None else valid_s[s], fr.on(d),
                                  lm.on(d), huber_delta)
        packed.append(p)
        local.append(loc)
    dth, dth_zeroed = _ba_reduced_step(_reduce(packed, devices[0]), free, lam, mesh_rules)
    dr = _PerDevice(dth)
    po_new = [_ba_backsub(local[s], dr.on(d), poses_s[s]) for s, d in enumerate(devices)]
    return dth_zeroed, po_new


def ba_lm(project_fn, theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid,
          devices, one_focal: bool, opts: LMOptions, mesh_rules: bool = False,
          jac_f32: bool = False):
    """The single-camera LM (``ba_solve``'s arguments) with the frames split
    into contiguous shards over ``devices``: poses and observations stay
    on their shard, each iteration reduces one packed system (``ba_step``)
    and the robust cost on the first device.  F must be a multiple of
    ``len(devices)``; results on the first device.  The damping loop runs
    on the devices by the route ``_route`` picks: one fused graph per
    chunk when every shard lies on one card (``_device_loop``), per-shard
    graphs over several cards (``_shard_loop``), else eagerly.

    ``mesh_rules``: the JAX package's frame-sharded rules (``ba_step``'s
    step order, and a stall on the rejection count alone, whatever lam).
    ``jac_f32``: float32 Jacobians (see ``ba_solve``).
    """
    dev0 = devices[0]
    S = len(devices)
    fv_s = _split(frame_valid, devices)
    w_s = [ws * fv[:, None] for ws, fv in zip(_split(w, devices), fv_s)]
    problem = (lo.to(dev0), hi.to(dev0), free.to(dev0), *[p3d.to(d) for d in devices],
               *_split(p2d, devices), *w_s, *fv_s)
    init = (theta0.to(dev0), *_split(poses0, devices))
    route = _route(devices)
    if route == "shards":
        (theta,), poses_s, cost, n_iters = _shard_loop(
            "ba", _BA_PHASES, (project_fn, one_focal, opts, mesh_rules, jac_f32, S),
            *_ba_holders(devices, problem, init), n_written=6, n_written0=4, n_params=1)
    else:
        static = (project_fn, one_focal, opts, tuple(devices), mesh_rules, jac_f32)
        example = (*init, *_lm_scalars(opts, torch.zeros((), dtype=theta0.dtype, device=dev0)))
        state, n_iters = _device_loop("ba", _ba_start, _ba_chunk, static, problem, example,
                                      init, graphed=route == "fused")
        (theta,), poses_s, (_, cost, *_) = _take(state, 1, S)
    return BAResult(theta, _gather(poses_s, dev0), cost, n_iters)


def _ba_parts(static, tensors):
    """``ba_lm``'s flat tensors as (lo, hi, free, p3d_s, p2d_s, w_s, fv_s,
    the rest) and the shards' residual functions."""
    project_fn, one_focal, _, devices, _, jac_f32 = static
    S = len(devices)
    (lo, hi, free), p3d_s, p2d_s, w_s, fv_s, rest = _take(tensors, 3, S, S, S, S)
    fns = [ba_frame_fns(project_fn, p3d_s[s], one_focal, jac_f32) for s in range(S)]
    return lo, hi, free, p2d_s, w_s, fv_s, rest, fns


def _ba_local_cost(residuals, theta, poses, p2d, w, huber_delta):
    """One shard's robust cost."""
    r = residuals(theta, poses, p2d)
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(w * huber_cost(r2, huber_delta))


def _ba_cost(static, fns, theta, poses_s, p2d_s, w_s):
    opts, devices = static[2], static[3]
    th = _PerDevice(theta)
    local = [_ba_local_cost(fns[s][0], th.on(d), poses_s[s], p2d_s[s], w_s[s],
                            opts.huber_delta) for s, d in enumerate(devices)]
    return _reduce(local, devices[0])


def _ba_start(*args):
    """``ba_lm``'s start: the clamped theta0, the poses0 shards, their cost
    and fresh scalars, written into the state buffers."""
    static, tensors = args[:6], args[6:]
    S = len(static[3])
    lo, hi, _, p2d_s, w_s, _, rest, fns = _ba_parts(static, tensors)
    state, (theta0,), poses0 = _take(rest, 1 + S + 6, 1)
    theta = torch.clamp(theta0, lo, hi)
    cost = _ba_cost(static, fns, theta, poses0, p2d_s, w_s)
    _write(state, (theta, *poses0, *_lm_scalars(static[2], cost)))


def _ba_chunk(*args):
    """``n`` iterations of ``ba_lm``'s damping loop on the state buffers,
    in place; returns ``_status``."""
    static, n, tensors = args[:6], args[6], args[6 + 1:]
    _, _, opts, devices, mesh_rules, _ = static
    S = len(devices)
    lo, hi, free, p2d_s, w_s, fv_s, state, fns = _ba_parts(static, tensors)
    (theta,), poses_s, st = _take(state, 1, S)
    st = tuple(st)
    jacs = [jac for _, jac in fns]
    stall_lam = 0.0 if mesh_rules else opts.stall_lam
    for _ in range(n):
        dth, po_new = ba_step(jacs, theta, poses_s, p2d_s, w_s, fv_s, free, st[0],
                              devices, opts.huber_delta, mesh_rules)
        th_new = torch.clamp(theta + dth * free, lo, hi)
        accept, st = _lm_update(opts, stall_lam, st,
                                _ba_cost(static, fns, th_new, po_new, p2d_s, w_s))
        theta = torch.where(accept, th_new, theta)
        acc = _PerDevice(accept)
        poses_s = [torch.where(acc.on(d), pn, po)
                   for d, pn, po in zip(devices, po_new, poses_s)]
    _write(state, (theta, *poses_s, *st))
    return _status(st)


def _iterate_message(params, lam, accept):
    """What the shards receive from the first device: the iterate's
    tensors flattened, lam and accept (as 0 / 1), in one tensor."""
    return torch.cat([*(p.reshape(-1) for p in params), lam.reshape(1),
                      accept.to(lam.dtype).reshape(1)])


def _lam0(opts, like):
    return torch.full((), opts.lam0, dtype=like.dtype, device=like.device)


def _blank(like, device, *shapes):
    """Unwritten buffers of ``like``'s dtype on ``device``: the examples of
    what a phase receives or writes before any phase reads it (a
    capture's warm-up runs on whatever they hold; no kernel fills them)."""
    return [torch.empty(shape, dtype=like.dtype, device=device) for shape in shapes]


def _blank_scalars(like):
    """Unwritten buffers shaped as ``_lm_scalars``'."""
    dt, dev = like.dtype, like.device
    return [torch.empty((), dtype=t, device=dev)
            for t in (dt, dt, torch.int64, torch.bool, torch.int64, torch.bool)]


def _ba_holders(devices, problem, init):
    """Example values of ``ba_lm``'s per-shard buffers for ``_shard_loop``:
    per shard (free, p3d, p2d, w, fv, poses; the iterate message (theta,
    lam, accept); the step (dth, trial theta); trial poses, Ainv_Bt,
    Ainv_g), and on the first device (lo, hi, free, theta0; S partials, S
    costs; theta, the six scalars; the trial theta)."""
    S = len(devices)
    (lo, hi, free), p3d_s, p2d_s, w_s, fv_s, _ = _take(problem, 3, S, S, S, S)
    theta0, poses0_s = init[0], init[1:]
    k = theta0.shape[0]
    shards = [(free.to(d), p3d_s[s], p2d_s[s], w_s[s], fv_s[s], poses0_s[s],
               *_blank(theta0, d, (k + 2,), (2 * k,), (F, 6), (F, 6, k), (F, 6)))
              for s, d in enumerate(devices) for F in [poses0_s[s].shape[0]]]
    first = (lo, hi, free, theta0, *_blank(theta0, theta0.device, *[(2 * k + 1, k)] * S,
                                          *[()] * S, (k,)),
             *_blank_scalars(theta0), *_blank(theta0, theta0.device, (k,)))
    return shards, first


def _ba_shard(static, held):
    """A shard's buffers: (opts, free, p3d, p2d, w, fv, poses, message,
    step, trial poses, Ainv_Bt, Ainv_g) and its residual functions'
    factory."""
    project_fn, one_focal, opts, _, jac_f32, _ = static
    p3d = held[1]
    return (opts, *held,
            lambda f32=jac_f32: ba_frame_fns(project_fn, p3d, one_focal, f32))


def _ba_system(*args):
    """Phase (a) of ``ba_lm`` on one shard: commit the accepted poses, then
    the packed partial of the step at the received theta and lam."""
    opts, free, _, p2d, w, fv, poses, msg, _, po_new, ainv_bt, ainv_g, fns = _ba_shard(
        args[:6], args[6:])
    k = free.shape[0]
    poses.copy_(torch.where(msg[k + 1] > 0, po_new, poses))
    packed, (a, g, _) = _ba_shard_system(fns()[1], msg[:k].clone(), poses, p2d, w, fv, free,
                                         msg[k].clone(), opts.huber_delta)
    _write((ainv_bt, ainv_g), (a, g))
    return packed


def _ba_trial(*args):
    """Phase (c) of ``ba_lm`` on one shard: back-substitute the received
    step into trial poses; their local cost at the trial theta."""
    opts, free, _, p2d, w, fv, poses, _, step, po_new, ainv_bt, ainv_g, fns = _ba_shard(
        args[:6], args[6:])
    k = free.shape[0]
    trial = _ba_backsub((ainv_bt, ainv_g, fv), step[:k].clone(), poses)
    po_new.copy_(trial)
    return _ba_local_cost(fns(False)[0], step[k:].clone(), trial, p2d, w, opts.huber_delta)


def _ba_cost0(*args):
    """The start of ``ba_lm`` on one shard: the local cost at the
    received theta and the first poses."""
    opts, free, _, p2d, w, _, poses, msg, *_, fns = _ba_shard(args[:6], args[6:])
    return _ba_local_cost(fns(False)[0], msg[: free.shape[0]].clone(), poses, p2d, w,
                          opts.huber_delta)


def _ba_first(static, held):
    """The first device's buffers: (opts, stall lam, lo, hi, free, theta0,
    partials, costs, theta, scalars, trial theta)."""
    opts, mesh_rules, S = static[2], static[3], static[5]
    (lo, hi, free, theta0), parts, costs, (theta,), st, (th_new,) = _take(held, 4, S, S, 1, 6)
    return (opts, 0.0 if mesh_rules else opts.stall_lam, lo, hi, free, theta0, parts, costs,
            theta, st, th_new)


def _ba_start_first(*args):
    """The start of ``ba_lm`` on the first device: the clamped theta0, and
    the iterate message (theta, lam0, no accept)."""
    opts, _, lo, hi, _, theta0, _, _, theta, _, _ = _ba_first(args[:6], args[6:])
    theta.copy_(torch.clamp(theta0, lo, hi))
    return _iterate_message((theta,), _lam0(opts, theta), theta.new_zeros((), dtype=torch.bool))


def _ba_scalars(*args):
    """The start of ``ba_lm`` on the first device: fresh scalars beside the
    summed costs."""
    opts, *_, costs, _, st, _ = _ba_first(args[:6], args[6:])
    _write(st, _lm_scalars(opts, _reduce(costs, costs[0].device)))


def _ba_solve_first(*args):
    """Phase (b) of ``ba_lm`` on the first device: the partials summed in
    shard order, the k x k solve, the trial theta; returns the step the
    shards receive (the back-substituted step, the trial theta)."""
    static = args[:6]
    _, _, lo, hi, free, _, parts, _, theta, st, th_new = _ba_first(static, args[6:])
    dth, dth_zeroed = _ba_reduced_step(_reduce(parts, theta.device), free, st[0], static[3])
    trial = torch.clamp(theta + dth_zeroed * free, lo, hi)
    th_new.copy_(trial)
    return torch.cat([dth, trial])


def _ba_update(*args):
    """Phase (d) of ``ba_lm`` on the first device: the costs summed in
    shard order, the LM's verdict; returns (the iterate message,
    ``_status``)."""
    opts, stall_lam, *_, costs, theta, st, th_new = _ba_first(args[:6], args[6:])
    accept, st_n = _lm_update(opts, stall_lam, tuple(st), _reduce(costs, theta.device))
    theta_n = torch.where(accept, th_new, theta)
    _write((theta, *st), (theta_n, *st_n))
    return _iterate_message((theta_n,), st_n[0], accept), _status(st_n)


_BA_PHASES = _Phases(start=_ba_start_first, cost0=_ba_cost0, scalars=_ba_scalars,
                     system=_ba_system, solve=_ba_solve_first, trial=_ba_trial,
                     update=_ba_update)


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
    frames carry frame_valid = 0); results on the first device.  The
    damping loop runs on the devices by the route ``_route`` picks (see
    ``ba_lm``).

    ``mesh_rules``: stall on the rejection count alone, whatever lam (the
    JAX package's frame-sharded rule).  ``jac_f32``: float32 Jacobians
    (see ``ba_solve``).
    """
    C = p2d.shape[0]
    dtype = theta0.dtype
    dev0 = devices[0]
    S = len(devices)
    lo, hi, free = lo.to(dev0), hi.to(dev0), free.to(dev0)
    w = w * cam_frame_valid[:, :, None] * frame_valid[None, :, None]
    shards = (*[p3d.to(d) for d in devices], *_split(p2d, devices, dim=1),
              *_split(w, devices, dim=1), *_split(frame_valid, devices))
    init = (theta0.to(dev0), ext0.to(dev0), *_split(poses0, devices))
    route = _route(devices)
    if route == "shards":
        (theta, ext), poses_s, cost, n_iters = _shard_loop(
            "multi", _MULTI_PHASES, (project_fn, one_focal, opts, mesh_rules, jac_f32, S),
            *_multi_holders(devices, (lo, hi, free, *shards), init), n_written=6,
            n_written0=5, n_params=2)
    else:
        ext_free = _ext_free(C, free)
        problem = (lo, hi, free, ext_free, _unit_fixed(free, ext_free), *shards)
        static = (project_fn, one_focal, opts, tuple(devices), mesh_rules, jac_f32)
        example = (*init, *_lm_scalars(opts, torch.zeros((), dtype=dtype, device=dev0)))
        state, n_iters = _device_loop("multi", _multi_start, _multi_chunk, static, problem,
                                      example, init, graphed=route == "fused")
        (theta, ext), poses_s, (_, cost, *_) = _take(state, 2, S)
    return MultiBAResult(theta, ext, _gather(poses_s, dev0), cost, n_iters)


def _ext_free(C, free):
    """The extrinsics' free mask: e_0 is pinned to identity (its columns
    get a unit diagonal), the others are free."""
    return torch.cat([torch.zeros((1, 6), dtype=free.dtype, device=free.device),
                      torch.ones((C - 1, 6), dtype=free.dtype, device=free.device)], dim=0)


def _unit_fixed(free, ext_free):
    """The reduced system's unit diagonal for fixed variables."""
    return torch.diag(1.0 - torch.cat([free.reshape(-1), ext_free.reshape(-1)]))


def _multi_parts(static, tensors):
    """``multi_ba_lm``'s flat tensors as (lo, hi, free, ext_free,
    unit_fixed, p2d_s, w_s, fv_s, the rest) and the shards' per-camera
    functions."""
    project_fn, one_focal, _, devices, _, jac_f32 = static
    S = len(devices)
    fixed, p3d_s, p2d_s, w_s, fv_s, rest = _take(tensors, 5, S, S, S, S)
    C = p2d_s[0].shape[0]
    fns = [multi_frame_fns(project_fn, p3d_s[s], one_focal, C, jac_f32) for s in range(S)]
    return (*fixed, p2d_s, w_s, fv_s, rest, fns)


def _multi_local_cost(fns, theta, ext, poses, p2d, w, huber_delta):
    """One shard's robust cost over every camera."""
    total = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for c in range(theta.shape[0]):
        r = fns[c][0](theta[c], ext[c], poses, p2d[c])
        r2 = torch.sum(r * r, dim=-1)
        total = total + torch.sum(w[c] * huber_cost(r2, huber_delta))
    return total


def _multi_cost(static, fns, theta, ext, poses_s, p2d_s, w_s):
    opts, devices = static[2], static[3]
    th, ex = _PerDevice(theta), _PerDevice(ext)
    local = [_multi_local_cost(fns[s], th.on(d), ex.on(d), poses_s[s], p2d_s[s], w_s[s],
                               opts.huber_delta) for s, d in enumerate(devices)]
    return _reduce(local, devices[0])


def _multi_start(*args):
    """``multi_ba_lm``'s start: the clamped theta0, ext0, the poses0 shards,
    their cost and fresh scalars, written into the state buffers."""
    static, tensors = args[:6], args[6:]
    S = len(static[3])
    lo, hi, _, _, _, p2d_s, w_s, _, rest, fns = _multi_parts(static, tensors)
    state, (theta0, ext0), poses0 = _take(rest, 2 + S + 6, 2)
    theta = torch.clamp(theta0, lo, hi)
    cost = _multi_cost(static, fns, theta, ext0, poses0, p2d_s, w_s)
    _write(state, (theta, ext0, *poses0, *_lm_scalars(static[2], cost)))


def _multi_shard_system(fns, theta, ext, poses, p2d, w, fv, free, ext_free, lam,
                        huber_delta):
    """One shard's share of a damped joint Schur step: its normal blocks
    (``_multi_shard_blocks``), the board poses' 6x6 solves and the partial
    Schur sums.  Returns (the packed (U | Schur correction | rhs |
    gradient) partial (2M+2, M), (Ainv_Bt, Ainv_g) for the
    back-substitution)."""
    U, g_x, A, B, g_p = _multi_shard_blocks(fns, theta, ext, poses, p2d, w, free, ext_free,
                                            huber_delta)
    eye6 = torch.eye(6, dtype=theta.dtype, device=theta.device)
    Ad = torch.where(fv[:, None, None] > 0, _damped(A, lam), eye6)
    sol = cholesky_solve_batched_small(Ad, torch.cat([B.mT, g_p[..., None]], dim=2))
    Ainv_Bt, Ainv_g = sol[..., :-1], sol[..., -1]  # (F, 6, M), (F, 6)
    corr = torch.einsum("fij,fjk->ik", B, Ainv_Bt)
    rhs = -(g_x - torch.einsum("fik,fi->k", Ainv_Bt, g_p))
    return torch.cat([U, corr, rhs[None, :], g_x[None, :]], dim=0), (Ainv_Bt, Ainv_g)


def _multi_reduced_step(tot, unit_fixed, lam):
    """The M x M solve of the summed packed system ``tot``: (the raw step,
    the summed gradient)."""
    M = tot.shape[1]
    U, corr, rhs, g_x = tot[:M], tot[M : 2 * M], tot[2 * M], tot[2 * M + 1]
    S_ = _damped(U + unit_fixed, lam) - corr
    # Jacobi-scale the reduced solve: parameter magnitudes span ~1e5
    # (focal vs distortion vs extrinsic rotation); D S D has a unit
    # diagonal and solves identically
    dg = torch.sqrt(torch.clamp(torch.diagonal(S_), min=1e-12))
    Sn = S_ / dg[:, None] / dg[None, :]
    return cholesky_solve_batched_small(Sn, rhs / dg) / dg, g_x


def _multi_backsub(local, dx, poses, fv):
    """One shard's board poses after the raw step ``dx``."""
    Ainv_Bt, Ainv_g = local
    dpo = -(Ainv_g + torch.einsum("fim,m->fi", Ainv_Bt, dx))
    return poses + _finite_or_zero(dpo) * fv[:, None]


def _multi_trial(theta, ext, dx, free, ext_free, lo, hi):
    """The trial intrinsics and extrinsics of the zeroed step ``dx``."""
    C, k = theta.shape
    th_new = torch.clamp(theta + dx[: C * k].reshape(C, k) * free, lo, hi)
    return th_new, ext + dx[C * k :].reshape(C, 6) * ext_free


def _gradient_small(g_x, cost):
    """The joint BA's second stop: a vanished gradient.  Large joint
    problems keep finding micro-improvements at the noise floor."""
    return torch.max(torch.abs(g_x)) <= 1e-9 * torch.clamp(cost, min=1.0)


def _multi_chunk(*args):
    """``n`` iterations of ``multi_ba_lm``'s damping loop on the state
    buffers, in place; returns ``_status``."""
    static, n, tensors = args[:6], args[6], args[6 + 1:]
    _, _, opts, devices, mesh_rules, _ = static
    S = len(devices)
    lo, hi, free, ext_free, unit_fixed, p2d_s, w_s, fv_s, state, fns = _multi_parts(
        static, tensors)
    (theta, ext), poses_s, st = _take(state, 2, S)
    st = tuple(st)
    free_r, ext_free_r = _PerDevice(free), _PerDevice(ext_free)
    stall_lam = 0.0 if mesh_rules else opts.stall_lam
    for _ in range(n):
        th, ex, lm = _PerDevice(theta), _PerDevice(ext), _PerDevice(st[0])
        packed, local = [], []
        for s, d in enumerate(devices):
            p, loc = _multi_shard_system(fns[s], th.on(d), ex.on(d), poses_s[s], p2d_s[s],
                                         w_s[s], fv_s[s], free_r.on(d), ext_free_r.on(d),
                                         lm.on(d), opts.huber_delta)
            packed.append(p)
            local.append(loc)
        dx, g_x = _multi_reduced_step(_reduce(packed, devices[0]), unit_fixed, st[0])
        dxr = _PerDevice(dx)
        po_new = [_multi_backsub(local[s], dxr.on(d), poses_s[s], fv_s[s])
                  for s, d in enumerate(devices)]
        th_new, ex_new = _multi_trial(theta, ext, _finite_or_zero(dx), free, ext_free, lo, hi)
        # stop on a tiny relative decrease OR a vanished gradient
        accept, st = _lm_update(
            opts, stall_lam, st,
            _multi_cost(static, fns, th_new, ex_new, po_new, p2d_s, w_s),
            _gradient_small(g_x, st[1]))
        theta = torch.where(accept, th_new, theta)
        ext = torch.where(accept, ex_new, ext)
        acc = _PerDevice(accept)
        poses_s = [torch.where(acc.on(d), pn, po)
                   for d, pn, po in zip(devices, po_new, poses_s)]
    _write(state, (theta, ext, *poses_s, *st))
    return _status(st)


def _multi_holders(devices, problem, init):
    """Example values of ``multi_ba_lm``'s per-shard buffers for
    ``_shard_loop``: per shard (free, p3d, p2d, w, fv, poses; the iterate
    message (theta, ext, lam, accept); the step (dx, trial theta, trial
    ext); trial poses, Ainv_Bt, Ainv_g), and on the first device (lo, hi,
    free, theta0, ext0; S partials, S costs; theta, ext, the six scalars;
    the trial theta and ext and the vanished-gradient flag)."""
    S = len(devices)
    (lo, hi, free), p3d_s, p2d_s, w_s, fv_s, _ = _take(problem, 3, S, S, S, S)
    theta0, ext0, poses0_s = init[0], init[1], init[2:]
    C, k = theta0.shape
    M, dev0 = C * k + 6 * C, theta0.device
    shards = [(free.to(d), p3d_s[s], p2d_s[s], w_s[s], fv_s[s], poses0_s[s],
               *_blank(theta0, d, (M + 2,), (2 * M,), (F, 6), (F, 6, M), (F, 6)))
              for s, d in enumerate(devices) for F in [poses0_s[s].shape[0]]]
    first = (lo, hi, free, theta0, ext0,
             *_blank(theta0, dev0, *[(2 * M + 2, M)] * S, *[()] * S, (C, k), (C, 6)),
             *_blank_scalars(theta0), *_blank(theta0, dev0, (C, k), (C, 6)),
             torch.empty((), dtype=torch.bool, device=dev0))
    return shards, first


def _multi_shard(static, held):
    """A shard's buffers and what they imply: (opts, free, ext_free, p2d,
    w, fv, poses, message, step, trial poses, Ainv_Bt, Ainv_g) and its
    per-camera functions' factory."""
    project_fn, one_focal, opts, _, jac_f32, _ = static
    free, p3d, *rest = held
    return (opts, free, _ext_free(free.shape[0], free), *rest,
            lambda f32=jac_f32: multi_frame_fns(project_fn, p3d, one_focal, free.shape[0], f32))


def _multi_iterate(msg, C, k):
    """(theta, ext, lam) of an iterate message."""
    return (msg[: C * k].reshape(C, k).clone(), msg[C * k : C * k + 6 * C].reshape(C, 6).clone(),
            msg[-2].clone())


def _multi_system(*args):
    """Phase (a) of ``multi_ba_lm`` on one shard: commit the accepted
    poses, then the packed partial of the step at the received iterate."""
    opts, free, ext_free, p2d, w, fv, poses, msg, _, po_new, ainv_bt, ainv_g, fns = (
        _multi_shard(args[:6], args[6:]))
    theta, ext, lam = _multi_iterate(msg, *free.shape)
    poses.copy_(torch.where(msg[-1] > 0, po_new, poses))
    packed, (a, g) = _multi_shard_system(fns(), theta, ext, poses, p2d, w, fv, free, ext_free,
                                         lam, opts.huber_delta)
    _write((ainv_bt, ainv_g), (a, g))
    return packed


def _multi_trial_cost(*args):
    """Phase (c) of ``multi_ba_lm`` on one shard: back-substitute the
    received step into trial poses; their local cost at the trial
    intrinsics and extrinsics."""
    opts, free, _, p2d, w, fv, poses, _, step, po_new, ainv_bt, ainv_g, fns = _multi_shard(
        args[:6], args[6:])
    C, k = free.shape
    M = C * k + 6 * C
    trial = _multi_backsub((ainv_bt, ainv_g), step[:M].clone(), poses, fv)
    po_new.copy_(trial)
    return _multi_local_cost(fns(False), step[M : M + C * k].reshape(C, k).clone(),
                             step[M + C * k :].reshape(C, 6).clone(), trial, p2d, w,
                             opts.huber_delta)


def _multi_cost0(*args):
    """The start of ``multi_ba_lm`` on one shard: the local cost at the
    received iterate and the first poses."""
    opts, free, _, p2d, w, _, poses, msg, *_, fns = _multi_shard(args[:6], args[6:])
    theta, ext, _ = _multi_iterate(msg, *free.shape)
    return _multi_local_cost(fns(False), theta, ext, poses, p2d, w, opts.huber_delta)


def _multi_first(static, held):
    """The first device's buffers and what they imply: (opts, stall lam,
    lo, hi, free, ext_free, unit_fixed, theta0, ext0, partials, costs,
    theta, ext, scalars, trial theta, trial ext, vanished-gradient
    flag)."""
    opts, mesh_rules, S = static[2], static[3], static[5]
    (lo, hi, free, theta0, ext0), parts, costs, (theta, ext), st, scratch = _take(
        held, 5, S, S, 2, 6)
    ext_free = _ext_free(free.shape[0], free)
    return (opts, 0.0 if mesh_rules else opts.stall_lam, lo, hi, free, ext_free,
            _unit_fixed(free, ext_free), theta0, ext0, parts, costs, theta, ext, st, *scratch)


def _multi_start_first(*args):
    """The start of ``multi_ba_lm`` on the first device: the clamped
    theta0 and ext0, and the iterate message (theta, ext, lam0, no
    accept)."""
    opts, _, lo, hi, _, _, _, theta0, ext0, _, _, theta, ext, *_ = _multi_first(
        args[:6], args[6:])
    _write((theta, ext), (torch.clamp(theta0, lo, hi), ext0))
    return _iterate_message((theta, ext), _lam0(opts, theta),
                            theta.new_zeros((), dtype=torch.bool))


def _multi_scalars(*args):
    """The start of ``multi_ba_lm`` on the first device: fresh scalars
    beside the summed costs."""
    opts, *_, costs, _, _, st, _, _, _ = _multi_first(args[:6], args[6:])
    _write(st, _lm_scalars(opts, _reduce(costs, costs[0].device)))


def _multi_solve_first(*args):
    """Phase (b) of ``multi_ba_lm`` on the first device: the partials
    summed in shard order, the M x M solve, the trial iterate and the
    vanished-gradient test; returns the step the shards receive (the raw
    step, the trial theta and ext)."""
    (_, _, lo, hi, free, ext_free, unit_fixed, _, _, parts, _, theta, ext, st, th_new, ex_new,
     gsmall) = _multi_first(args[:6], args[6:])
    dx, g_x = _multi_reduced_step(_reduce(parts, theta.device), unit_fixed, st[0])
    th_t, ex_t = _multi_trial(theta, ext, _finite_or_zero(dx), free, ext_free, lo, hi)
    _write((th_new, ex_new, gsmall), (th_t, ex_t, _gradient_small(g_x, st[1])))
    return torch.cat([dx, th_t.reshape(-1), ex_t.reshape(-1)])


def _multi_update(*args):
    """Phase (d) of ``multi_ba_lm`` on the first device: the costs summed
    in shard order, the LM's verdict; returns (the iterate message,
    ``_status``)."""
    opts, stall_lam, *_, costs, theta, ext, st, th_new, ex_new, gsmall = _multi_first(
        args[:6], args[6:])
    accept, st_n = _lm_update(opts, stall_lam, tuple(st), _reduce(costs, theta.device), gsmall)
    theta_n = torch.where(accept, th_new, theta)
    ext_n = torch.where(accept, ex_new, ext)
    _write((theta, ext, *st), (theta_n, ext_n, *st_n))
    return _iterate_message((theta_n, ext_n), st_n[0], accept), _status(st_n)


_MULTI_PHASES = _Phases(start=_multi_start_first, cost0=_multi_cost0, scalars=_multi_scalars,
                        system=_multi_system, solve=_multi_solve_first, trial=_multi_trial_cost,
                        update=_multi_update)


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
