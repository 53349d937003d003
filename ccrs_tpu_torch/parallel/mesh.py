"""Frame-sharded bundle adjustment and detection over a list of devices.

Port of ``ccrs_tpu/parallel/mesh.py``.  The calibration problem's only
cross-frame coupling is the reduced (intrinsics) normal-equation system —
pose blocks are per-frame — so the frame batch is split across devices and
the small Schur system is summed over the shards.  Detection is
frame-parallel and uses the same split.

The design is single-process, like the JAX package's single-controller
``shard_map``:

- a mesh is an ordered list of ``torch.device``s (``make_mesh``); an entry
  may repeat, so two shards can live on one card (the code path, not
  scaling) and the CPU tests run eight CPU shards;
- frames are split into contiguous shards, one per mesh entry, after
  ``pad_frames`` pads F to a multiple of the mesh size (padding frames
  carry zero weight).

The solvers are ``ba_solve``'s and ``ba_solve_multi``'s own bodies
(``solve.lm.ba_lm`` / ``multi_ba_lm``), which run over a device list; the
unsharded solvers are their one-device case.  Over a mesh:

- each shard computes its residuals, ``torch.func`` Jacobians (under
  ``solve/lm.py``'s Jacobian lock), pose blocks and partial Schur sums on
  its own device;
- each LM iteration then reduces exactly one packed system, ``U | Schur
  correction | rhs`` for the single camera and ``U | corr | rhs | g`` for
  the joint BA, and the robust cost the same way: the packed tensors move
  to the first device and are summed there in shard order (the ``psum``);
- the k x k (or M x M) solve runs once on the first device, and its step
  is copied back to the shards, whose pose updates stay local.

The solvers here take ``mesh.py``'s rules (``mesh_rules``), which differ
from ``ba_solve``'s and ``ba_solve_multi``'s in two places: both stall on
the rejection count alone, where those also require ``lam >= stall_lam``;
and the single-camera step zeroes a non-finite intrinsics step before the
poses' back-substitution.  They exit on ``rtol`` after an accepted step,
and the joint BA also on a vanished gradient.

``make_mesh()`` returns the visible CUDA devices, or the list set by
``default_mesh`` (which plays the part of the
``--xla_force_host_platform_device_count`` flag that gives JAX its virtual
devices); ``TagDetector`` and the joint BA's route call it themselves,
through ``mesh_for``, and shard only over devices of the type the caller
asked for.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..solve.lm import (
    LMOptions,
    MultiBAResult,
    _as,
    _gather,
    _PerDevice,
    _polish_jac_f32,
    _split,
    ba_frame_fns,
    ba_lm,
    ba_step,
    multi_ba_lm,
    polish_rtol,
)

Mesh = List[torch.device]

_default: Optional[Mesh] = None


@contextlib.contextmanager
def default_mesh(devices: Sequence):
    """Inside the block ``make_mesh()`` returns ``devices`` (an ordered
    list; entries may repeat) instead of the visible CUDA devices; the
    previous list comes back on exit."""
    global _default
    prev = _default
    _default = [torch.device(d) for d in devices]
    try:
        yield list(_default)
    finally:
        _default = prev


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first ``n_devices`` (default: all) of the mesh: the visible CUDA
    devices, or the list set by ``default_mesh``.  Raises when asked for
    more devices than that; never falls back to the CPU."""
    if _default is not None:
        devs = list(_default)
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devs)} device(s) in the "
                "mesh; run on more cards or set a list with default_mesh"
            )
        devs = devs[:n_devices]
    return devs


def mesh_for(device) -> Mesh:
    """``make_mesh()`` when every entry has ``device``'s type, else an empty
    mesh: a caller that asked for the CPU never runs on the cards, and the
    other way round."""
    mesh = make_mesh()
    kind = torch.device(device).type
    return mesh if all(d.type == kind for d in mesh) else []


def _pad(a, pad: int, dim: int = 0):
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=dim)


def pad_frames(arrs, n_devices: int):
    """Pad the leading (frame) axis of each tensor with zeros to a multiple
    of the mesh size; returns (padded tensors, original F).  Padding rows
    carry zero weight."""
    F = arrs[0].shape[0]
    pad = (-F) % n_devices
    return [_pad(a, pad) if pad else a for a in arrs], F


def _check_mesh(mesh: Mesh) -> Mesh:
    if not mesh:
        raise ValueError("empty mesh: no device to shard over")
    return [torch.device(d) for d in mesh]


# --------------------------------------------------------------------------
# single-camera sharded LM
# --------------------------------------------------------------------------


def make_ba_step(
    project_fn, mesh: Mesh, one_focal: bool = False, huber_delta: float = 1.0,
):
    """A frame-sharded LM step over ``mesh``: one iteration of the
    single-camera body (``solve.lm.ba_step``) with ``mesh.py``'s rules.

    Per shard: residuals/Jacobians, pose-block solves and partial Schur
    sums.  Across shards: one reduction of the packed (U | Schur
    correction | rhs) system; the k x k solve runs once on the first
    device and the pose updates stay on their shards.  Frames without
    weight get no update.

    Returned step: ``step(theta, poses, p3d, p2d, w, free, lam) ->
    (theta_new, poses_new)`` with F a multiple of the mesh size
    (``pad_frames``); both results on the first device.
    """
    mesh = _check_mesh(mesh)
    dev0 = mesh[0]

    def step(theta, poses, p3d, p2d, w, free, lam):
        theta, free = theta.to(dev0), free.to(dev0)
        lam = torch.as_tensor(lam, dtype=theta.dtype, device=dev0)
        p3d_r = _PerDevice(p3d)
        jacs = [ba_frame_fns(project_fn, p3d_r.on(d), one_focal)[1] for d in mesh]
        dth, po_new = ba_step(
            jacs, theta, _split(poses, mesh), _split(p2d, mesh), _split(w, mesh), None,
            free, lam, mesh, huber_delta, mesh_rules=True,
        )
        return theta + dth * free, _gather(po_new, dev0)

    return step


def ba_step_sharded(
    project_fn, theta, poses, p3d, p2d, w, free, lam, mesh: Mesh,
    one_focal: bool = False, huber_delta: float = 1.0,
):
    """One sharded LM step (see ``make_ba_step``)."""
    return make_ba_step(project_fn, mesh, one_focal, huber_delta)(
        theta, poses, p3d, p2d, w, free, lam
    )


def make_ba_solver(
    project_fn,
    mesh: Mesh,
    one_focal: bool = False,
    huber_delta: float = 1.0,
    max_iters: int = 60,
    rtol: float = 1e-14,
    jac_f32: bool = False,
):
    """A full frame-sharded LM solve over ``mesh``: ``ba_solve``'s body
    (``solve.lm.ba_lm``: damping schedule, accept/reject, bounds, free mask,
    Huber IRLS) with its frames split over the mesh and ``mesh.py``'s rules
    (the stall exit counts rejections only).  ``jac_f32``: float32
    Jacobians, as ``ba_solve``'s.

    Returned solve: ``solve(theta0, poses0, p3d, p2d, w, lo, hi, free,
    frame_valid) -> BAResult(theta, poses, cost, n_iters)`` with F a
    multiple of the mesh size (pad with ``pad_frames`` and zero
    weights); results on the first device.
    """
    mesh = _check_mesh(mesh)
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)

    def solve(theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid):
        return ba_lm(project_fn, theta0, poses0, p3d, p2d, w, lo, hi, free,
                     frame_valid, mesh, one_focal, opts, mesh_rules=True,
                     jac_f32=jac_f32)

    return solve


# --------------------------------------------------------------------------
# multi-camera sharded joint BA
# --------------------------------------------------------------------------


def make_multi_ba_solver(
    project_fn,
    mesh: Mesh,
    one_focal: bool = False,
    huber_delta: float = 1.0,
    max_iters: int = 60,
    rtol: float = 1e-14,
    jac_f32: bool = False,
):
    """A full frame-sharded joint multi-camera BA over ``mesh``:
    ``ba_solve_multi``'s body (``solve.lm.multi_ba_lm``: per-camera
    intrinsics + extrinsics T_i_0 + shared board poses T_0_b; reference
    ``src/util.rs:567-715``) with its frames split over the mesh and
    ``mesh.py``'s stall rule.  Board-pose blocks stay on their shards;
    each iteration reduces one packed (U | Schur correction | rhs |
    gradient) system of size (2M+2, M), M = C*k + 6C.  ``jac_f32``:
    float32 Jacobians, residual and cost in the caller's dtype (see
    ``solve.lm.ba_solve``).

    Returned solve: ``solve(theta0 (C,k), ext0 (C,6), poses0 (F,6), p3d,
    p2d (C,F,N,2), w (C,F,N), lo, hi, free (C,k), cam_frame_valid (C,F),
    frame_valid (F,)) -> MultiBAResult(theta, ext, poses, cost, n_iters)``
    with F a multiple of the mesh size (padding frames carry
    frame_valid = 0); results on the first device.
    """
    mesh = _check_mesh(mesh)
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)

    def solve(theta0, ext0, poses0, p3d, p2d, w, lo, hi, free, cam_frame_valid,
              frame_valid):
        return multi_ba_lm(project_fn, theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
                           cam_frame_valid, frame_valid, mesh, one_focal, opts,
                           mesh_rules=True, jac_f32=jac_f32)

    return solve


def multi_ba_sharded(
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
    huber_delta: float = 1.0,
    max_iters: int = 60,
    mesh: Optional[Mesh] = None,
) -> MultiBAResult:
    """Frame-sharded joint multi-camera BA over the mesh (default: every
    visible card) in one precision (``theta0``'s) — the ``solver="f64"``
    route of ``calib_all_camera_with_extrinsics`` when the mesh has more
    than one device.

    It takes ``ba_solve_multi``'s argument layout with the frame axis
    unpadded, pads F to a multiple of the mesh size (padding frames carry
    zero frame_valid and weight), and crops the poses back to F, with
    ``ba_solve_multi``'s iteration limit and rtol.
    ``multi_ba_sharded_mixed`` is the two-stage solve.
    """
    mesh, args, F = _pad_to_mesh(mesh, poses0, p2d, w, cam_frame_valid, frame_valid)
    poses0, p2d, w, cam_frame_valid, frame_valid = args
    res = make_multi_ba_solver(project_fn, mesh, one_focal, huber_delta, max_iters)(
        theta0, ext0, poses0, p3d, p2d, w, lo, hi, free, cam_frame_valid, frame_valid,
    )
    return res._replace(poses=res.poses[:F])


def _pad_to_mesh(mesh, poses0, p2d, w, cam_frame_valid, frame_valid):
    """(mesh or the default one, the frame-axis arguments padded to a
    multiple of its size, the unpadded F)."""
    mesh = make_mesh() if mesh is None else mesh
    D = len(_check_mesh(mesh))
    F = poses0.shape[0]
    pad = (-F) % D
    if pad:
        poses0, frame_valid = _pad(poses0, pad), _pad(frame_valid, pad)
        p2d, w, cam_frame_valid = (_pad(a, pad, 1) for a in (p2d, w, cam_frame_valid))
    return mesh, (poses0, p2d, w, cam_frame_valid, frame_valid), F


def multi_ba_sharded_mixed(
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
    huber_delta: float = 1.0,
    max_iters: int = 60,
    polish_iters: int = 10,  # matches ba_solve_multi_mixed
    mesh: Optional[Mesh] = None,
    polish_jac_f32: bool = False,  # full-precision J: see ba_solve_multi_mixed
) -> MultiBAResult:
    """Frame-sharded, mixed-precision joint multi-camera BA over the mesh
    (default: every visible card) — the sharded twin of
    ``solve.lm.ba_solve_multi_mixed`` and the ``solver="mixed"`` route of
    ``calib_all_camera_with_extrinsics`` when the mesh has more than one
    device: a float32 descent (``rtol=1e-6``), then a polish of at most
    ``polish_iters`` iterations in ``theta0``'s dtype (``polish_rtol()``;
    ``CCRS_POLISH_JAC32`` as there), both through ``make_multi_ba_solver``.

    Takes ``ba_solve_multi``'s argument layout with the frame axis
    unpadded (see ``multi_ba_sharded``); returns a ``MultiBAResult`` with
    the poses cropped back to F, ``n_iters`` over both stages and
    ``n_polish`` for the second.
    """
    polish_jac_f32 = _polish_jac_f32(polish_jac_f32)
    mesh, args, F = _pad_to_mesh(mesh, poses0, p2d, w, cam_frame_valid, frame_valid)
    poses0, p2d, w, cam_frame_valid, frame_valid = args
    s1 = make_multi_ba_solver(
        project_fn, mesh, one_focal, huber_delta, max_iters, rtol=1e-6
    )(*_as(torch.float32, theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
           cam_frame_valid, frame_valid))
    dt = theta0.dtype
    s2 = make_multi_ba_solver(
        project_fn, mesh, one_focal, huber_delta, polish_iters,
        rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )(s1.theta.to(dt), s1.ext.to(dt), s1.poses.to(dt), p3d, p2d, w, lo, hi, free,
      cam_frame_valid, frame_valid)
    return MultiBAResult(s2.theta, s2.ext, s2.poses[:F], s2.cost,
                         s1.n_iters + s2.n_iters, s2.n_iters)


# --------------------------------------------------------------------------
# frame-sharded detection batches
# --------------------------------------------------------------------------


class FrameShards:
    """A (B, H, W) frame batch split into contiguous equal shards, shard i
    on mesh entry i: the counterpart of a batch placed with the JAX
    package's frame ``NamedSharding``.  ``device`` is the first shard's;
    ``index_select`` gathers frames from their shards onto it, and
    ``map_shards`` runs a per-frame function shard by shard."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.per_shard = int(self.parts[0].shape[0])
        self.shape = torch.Size(
            (self.per_shard * len(self.parts),) + tuple(self.parts[0].shape[1:])
        )
        self.dtype = self.parts[0].dtype
        self.device = self.parts[0].device

    def _locate(self, frames):
        """Group frame indices by shard: [(shard, local indices, positions
        in ``frames``)] for every shard holding one of them."""
        shard = frames // self.per_shard
        return [
            (s, frames[pos] - s * self.per_shard, pos)
            for s in range(len(self.parts))
            for pos in [np.flatnonzero(shard == s)]
            if pos.size
        ]

    def index_select(self, dim: int, index):
        """Frames ``index`` (host indices or an index tensor, as a tensor's
        ``index_select`` takes), gathered in order onto the first shard's
        device."""
        if dim != 0:
            raise ValueError("FrameShards gathers along the frame axis only")
        if isinstance(index, torch.Tensor):
            index = index.cpu()
        frames = np.asarray(index, np.int64)
        out = torch.empty((len(frames),) + tuple(self.shape[1:]), dtype=self.dtype,
                          device=self.device)
        for s, local, pos in self._locate(frames):
            sel = torch.as_tensor(local, device=self.parts[s].device)
            out[torch.as_tensor(pos, device=self.device)] = (
                self.parts[s].index_select(0, sel).to(self.device)
            )
        return out

    def map_shards(self, fn, frames=None) -> list:
        """Per-frame results of ``fn(part, local)`` for ``frames`` (host
        indices, default every frame), in ``frames`` order.  ``fn`` runs
        once on each shard holding one of them, on that shard's tensor,
        with ``local`` the indices into the shard (None for all of it), and
        returns one result per frame it was given."""
        frames = np.arange(self.shape[0]) if frames is None else np.asarray(frames, np.int64)
        out = [None] * len(frames)
        for s, local, pos in self._locate(frames):
            whole = np.array_equal(local, np.arange(self.per_shard))
            for p, r in zip(pos, fn(self.parts[s], None if whole else local)):
                out[p] = r
        return out


def shard_frames(frames, mesh: Mesh) -> FrameShards:
    """Split a (B, ...) tensor into contiguous shards over ``mesh`` (B a
    multiple of the mesh size)."""
    return FrameShards(p.contiguous() for p in _split(frames, _check_mesh(mesh)))
