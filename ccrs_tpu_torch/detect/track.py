"""Steady-state tag tracking: the video fast path of the detector.

Port of ``ccrs_tpu/detect/track.py``.  Calibration sequences are continuous
video, so the tracked detector (tracked.py) cold-detects anchor TRIPLES of
frames every ``cold_every`` frames and advances every inter-anchor segment
in "waves": wave w processes frame ``left+3+w`` of every segment (forward
sweep) and ``right-1-w`` (backward sweep) in one batched pass that

  - predicts every board tag's quad from the sweep's last frames
    (quadratic extrapolation for decoded tags, coasting for recently lost
    ones, a local homography from the 4 nearest decoded neighbours for the
    rest),
  - subpixel-refines the predicted corners on the current frame,
  - decodes and accepts only on tag-id match,
  - re-attempts what was not accepted from the same frame's accepted tags
    (the in-wave assist),
  - and carries the accepted corners to the segment's next frame.

Everything is batched tensor code on the frames' device.  The JAX package
writes it as one jitted graph; on the card the port replays it as one
captured CUDA graph per wave shape (``wave_step``, ``graphs.py``), and
runs it eagerly elsewhere.  The refine and
decode reuse the cold path's ``build_klt_maps``, ``refine_corners_mm``,
``unsharp_mm`` and ``_decode_core_dense``, in the branch of ``sample.py``
that the frames' device takes.  Image-space math is float32,
``coast_age`` int32, as in the JAX package.

Two places are written so the result does not depend on the library:

- neighbour selection is a STABLE ascending sort of the masked distances,
  which breaks the board grid's many exact distance ties toward the lower
  tag index, as ``jax.lax.top_k`` does (``torch.topk`` does not);
- the 8x8 normal equations of the homography fits are solved by an
  unrolled Cholesky with the JAX package's 1e-20 pivot floor and NaN
  poisoning of non-positive pivots (callers mask on ``isfinite``).
"""

from __future__ import annotations

import numpy as np
import torch

from .decode import _decode_core_dense
from .families import TagFamily
from .sample import build_klt_maps, refine_corners_mm, unsharp_mm

#: id-match acceptance allows a relaxed budget, like assist.ASSIST_EXTRA_HAMMING
TRACK_EXTRA_HAMMING = 2
#: below this many accepted tags a frame cannot seed the next prediction
MIN_TRACK_TAGS = 4
#: neighbors for the local-homography prediction of missing tags
N_NEIGHBORS = 4
#: degenerate/too-small predicted quads are not worth decoding (px^2)
MIN_QUAD_AREA = 49.0
#: predictions up to this many px outside the image still count as
#: "attempted", so a tag entering the view with a slightly stale prediction
#: becomes auditable instead of silently skipped
EDGE_MARGIN = 8.0
#: a failed decode counts as cold-equivalent (benign, non-triggering) only
#: when refinement moved every corner less than this
BENIGN_MAX_DISP = 3.0
#: acceptance requires the refine displacement to be below this: a refine
#: that ran to its total-shift clamp (sample.MAX_SHIFT) has not converged
#: and may still decode; it gets one restart in the in-wave assist
CONVERGED_MAX_DISP = 4.0
#: frames a lost tag coasts on its last position (advanced by its last
#: velocity) before prediction falls back to the local homography
MAX_COAST = 8

#: mask added to the distances of undecoded neighbours (float32)
_FAR = 1e12


def _cholesky_solve8(M, rhs):
    """Batched 8x8 SPD solve: M (Q, 8, 8), rhs (Q, 8) -> (Q, 8).

    The JAX package's unrolled Cholesky + forward/back substitution, with
    the same per-element operation order (subtractions in ascending k), a
    1e-20 floor under each pivot's square root, and NaN for every batch
    element with a non-positive pivot (``torch.linalg.cholesky`` would
    raise instead).  The factor and the forward pass run column by column
    over (Q, 8-j) slices, so the work is ~100 vectorized ops, not ~400.
    """
    n = 8
    L = torch.zeros_like(M)
    bad = torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    for j in range(n):
        s = M[:, j:, j]
        for k in range(j):
            s = s - L[:, j:, k] * L[:, j, k, None]
        piv = s[:, 0]
        bad = bad | (piv <= 0.0)
        ljj = torch.sqrt(torch.clamp(piv, min=1e-20))
        L[:, j, j] = ljj
        L[:, j + 1 :, j] = s[:, 1:] * (1.0 / ljj)[:, None]
    y = rhs.clone()
    for k in range(n):
        y[:, k] = y[:, k] / L[:, k, k]
        y[:, k + 1 :] = y[:, k + 1 :] - L[:, k + 1 :, k] * y[:, k, None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[:, i]
        for k in range(i + 1, n):
            s = s - L[:, k, i] * x[k]
        x[i] = s / L[:, i, i]
    out = torch.stack(x, dim=1)
    return torch.where(bad[:, None], torch.full_like(out, float("nan")), out)


def _fit_h_batch(src, dst):
    """Batched inhomogeneous DLT homography fit src -> dst.

    src/dst: (Q, n, 2).  Returns (Q, 3, 3) with H[2,2] == 1, fitted on
    mean/std-normalized coordinates (composed back) through the 8x8 normal
    equations.  Near-singular neighbour geometry yields a non-finite H;
    callers mask on isfinite.
    """
    Q, n, _ = src.shape
    dt, dev = src.dtype, src.device
    sm = src.mean(dim=1)
    ss = src.reshape(Q, -1).std(dim=1, correction=0) + 1e-12
    dm = dst.mean(dim=1)
    ds = dst.reshape(Q, -1).std(dim=1, correction=0) + 1e-12
    s = (src - sm[:, None]) / ss[:, None, None]
    d = (dst - dm[:, None]) / ds[:, None, None]
    A = torch.zeros((Q, 2 * n, 8), dtype=dt, device=dev)
    A[:, 0::2, 0:2] = s
    A[:, 0::2, 2] = 1.0
    A[:, 0::2, 6:8] = -d[:, :, :1] * s
    A[:, 1::2, 3:5] = s
    A[:, 1::2, 5] = 1.0
    A[:, 1::2, 6:8] = -d[:, :, 1:2] * s
    b = d.reshape(Q, -1)  # rows interleave (x_i, y_i) matching A
    M = A.mT @ A + 1e-6 * torch.eye(8, dtype=dt, device=dev)
    rhs = (A.mT @ b[:, :, None])[:, :, 0]
    h = _cholesky_solve8(M, rhs)
    Hn = torch.cat([h, torch.ones((Q, 1), dtype=dt, device=dev)], dim=1).reshape(Q, 3, 3)
    Ts = torch.zeros((Q, 3, 3), dtype=dt, device=dev)
    Ts[:, 0, 0] = 1.0 / ss
    Ts[:, 1, 1] = 1.0 / ss
    Ts[:, 0, 2] = -sm[:, 0] / ss
    Ts[:, 1, 2] = -sm[:, 1] / ss
    Ts[:, 2, 2] = 1.0
    Td = torch.zeros((Q, 3, 3), dtype=dt, device=dev)
    Td[:, 0, 0] = ds
    Td[:, 1, 1] = ds
    Td[:, 0, 2] = dm[:, 0]
    Td[:, 1, 2] = dm[:, 1]
    Td[:, 2, 2] = 1.0
    return Td @ Hn @ Ts


def _apply_h_batch(H, pts):
    """(Q, 3, 3) x (Q, n, 2) -> (Q, n, 2)."""
    p = torch.einsum("qij,qnj->qni", H[:, :, :2], pts) + H[:, None, :, 2]
    z = p[:, :, 2]
    z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    return p[:, :, :2] / z[:, :, None]


def board_centers_d2(board_xy):
    """Squared distances (n, n) between tag centres, float32.

    The board grid makes many of these distances tie exactly, and the
    ties decide which neighbours the homography predictions use, so the
    values are computed as the JAX package's compiled graph computes them:
    the centre sums the four corners in order, and XLA contracts
    ``dx*dx + dy*dy`` into ``fma(dy, dy, dx*dx)``, which is evaluated here
    in float64 (the float32 product is exact there) and rounded once to
    float32.  The result is the same on every device."""
    c = board_xy
    centers = (((c[:, 0] + c[:, 1]) + c[:, 2]) + c[:, 3]) / 4.0
    dx = centers[:, None, 0] - centers[None, :, 0]
    dy = (centers[:, None, 1] - centers[None, :, 1]).double()
    return (dy * dy + (dx * dx).double()).to(c.dtype)


def _nearest_valid(d2_all, valid):
    """The N_NEIGHBORS nearest tags that are ``valid`` in each row, for
    every tag: idx (R, n, N_NEIGHBORS), and ok (R, n) where all of them
    are valid.

    A stable ascending sort of the masked distances: ties go to the lower
    tag index, as ``jax.lax.top_k(-d2m, k)`` breaks them."""
    far = torch.where(
        valid, torch.zeros((), dtype=d2_all.dtype, device=valid.device),
        torch.full((), _FAR, dtype=d2_all.dtype, device=valid.device),
    )
    d2m = d2_all[None] + far[:, None, :]  # (R, n, n)
    d_near, idx = torch.sort(d2m, dim=-1, stable=True)
    return idx[..., :N_NEIGHBORS], (d_near[..., :N_NEIGHBORS] < 1e11).all(dim=-1)


def _neighbor_homography(board_xy, d2_all, valid, corners, shift=None):
    """Per row, per tag: the homography board -> image fitted on the
    N_NEIGHBORS nearest tags that are ``valid`` in that row, applied to
    the tag's own board corners, plus an optional per-row ``shift`` (R, 2).

    valid (R, n) bool, corners (R, n, 4, 2).  Returns (pred (R, n, 4, 2)
    with non-finite values zeroed, ok (R, n))."""
    R, n = valid.shape
    idx, nb_ok = _nearest_valid(d2_all, valid)
    src = board_xy[idx].reshape(R * n, -1, 2)
    rows = torch.arange(R, device=valid.device)[:, None, None]
    dst = corners[rows, idx].reshape(R * n, -1, 2)
    Hs = _fit_h_batch(src, dst)
    ph = _apply_h_batch(Hs, board_xy.repeat(R, 1, 1)).reshape(R, n, 4, 2)
    if shift is not None:
        ph = ph + shift[:, None, None, :]
    ok = nb_ok & torch.isfinite(ph).all(dim=-1).all(dim=-1)
    return torch.nan_to_num(ph), ok


def _orient_and_bound(pred, Hh: int, Ww: int):
    """Counter-clockwise quads flipped to clockwise, plus the in-bounds and
    minimum-area test of each (R, n, 4, 2) quad."""
    x, y = pred[..., 0], pred[..., 1]
    area2 = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(dim=-1)
    pred_t = torch.where((area2 < 0)[..., None, None], torch.flip(pred, dims=[-2]), pred)
    inb = (
        (x.amin(-1) >= -EDGE_MARGIN)
        & (y.amin(-1) >= -EDGE_MARGIN)
        & (x.amax(-1) <= Ww - 1 + EDGE_MARGIN)
        & (y.amax(-1) <= Hh - 1 + EDGE_MARGIN)
        & (0.5 * area2.abs() >= MIN_QUAD_AREA)
    )
    return pred_t, inb


def _predict_rows(board_xy, d2_all, c3, v3, c2, v2, c1, v1,
                  coast_c, coast_v, coast_age, Hh, Ww):
    """Batched one-frame-ahead prediction of every board tag's quad.

    Every argument carries a leading row axis R (one row = one independent
    track state).  Quadratic extrapolation through the last three
    observations, per-tag coasting for recently lost tags, local
    homography from the 4 nearest decoded neighbours otherwise.

    Returns (pred_t (R, n, 4, 2) clockwise, attempt (R, n), pred_id,
    coast_p, gvel (R, 2)).
    """
    both = v1 & v2
    vel = torch.where(both[..., None, None], c1 - c2, torch.zeros_like(c1))
    nv = torch.clamp(both.sum(dim=1), min=1)
    gvel = (vel * both[..., None, None]).sum(dim=(1, 2)) / (nv * 4)[:, None]
    quad_ok = both & v3
    pred_quad = 3.0 * c1 - 3.0 * c2 + c3
    pred_id = torch.where(quad_ok[..., None, None], pred_quad, c1 + vel)

    ph, h_ok = _neighbor_homography(board_xy, d2_all, v1, c1, shift=gvel)

    coast_p = coast_c + coast_v
    coasting = (~v1) & (coast_age <= MAX_COAST)
    pred = torch.where(
        v1[..., None, None],
        pred_id,
        torch.where(coasting[..., None, None], coast_p, ph),
    )
    pred_ok = v1 | coasting | h_ok
    pred_t, inb = _orient_and_bound(pred, Hh, Ww)
    return pred_t, pred_ok & inb, pred_id, coast_p, gvel


def wave_advance(family: TagFamily, images, board_xy, first_id: int,
                 carry, row_active):
    """Advance R independent track states by ONE frame each, batched.

    Args:
      images: (R, H, W) uint8/float32 — row r's current frame.
      board_xy: (n_tags, 4, 2) float32 board-plane tag corners.
      first_id: the board's first tag id.
      carry: tuple (c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age) of
        (R, n_tags, ...) tensors (float32 corners, bool validity, int32
        coast age) — per-row track state, time-ordered in the row's SWEEP
        direction (backward rows feed frames in reverse).
      row_active: (R,) bool — padding / exhausted rows decode nothing.

    Returns (new_carry, (corners, acc, att, benign)) with outputs shaped
    (R, n_tags, ...).  Rows never interact: a row's outputs do not depend
    on the other rows, active or not.
    """
    imgs = images.to(torch.float32)
    R, Hh, Ww = imgs.shape
    n_tags = board_xy.shape[0]
    dev = imgs.device
    c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age = carry
    d2_all = board_centers_d2(board_xy)
    exp_id = torch.arange(n_tags, device=dev) + int(first_id)
    max_ham = family.max_hamming + TRACK_EXTRA_HAMMING

    pred_t, attempt, pred_id, coast_p, gvel = _predict_rows(
        board_xy, d2_all, c3, v3, c2, v2, c1, v1,
        coast_c, coast_v, coast_age, Hh, Ww,
    )
    attempt = attempt & row_active[:, None]

    # one refine+decode over all R x n_tags predicted quads; the KLT maps
    # and the sharpened frames serve this pass and the in-wave assist
    maps = build_klt_maps(imgs)
    quads = refine_corners_mm(maps, pred_t.reshape(R, n_tags * 4, 2)).reshape(
        R, n_tags, 4, 2
    )
    sharp = unsharp_mm(imgs)
    dec = _decode_core_dense(family, sharp, quads, attempt)
    out_c = dec["corners"]
    id_match = dec["tag_id"] == exp_id[None, :]
    disp = torch.linalg.norm(quads - pred_t, dim=-1).amax(dim=-1)
    acc = attempt & dec["contrast_ok"] & id_match & (dec["hamming"] <= max_ham)
    # an id match on an unconverged (clamped) refine is not trustworthy:
    # it becomes a restart attempt below
    unconv = acc & (disp >= CONVERGED_MAX_DISP)
    acc = acc & ~unconv
    benign = attempt & ~acc & id_match & dec["contrast_ok"] & (disp < BENIGN_MAX_DISP)

    # ---- in-wave assist: re-attempt everything not accepted from the
    # CURRENT frame's accepted tags (the cold path's board-assist pass):
    # same-frame neighbour geometry predicts rim tags that extrapolation
    # carried past the refine capture radius, and tags entering the view
    safe_c = torch.where(acc[..., None, None], out_c, torch.zeros_like(out_c))
    ph2, h2_ok = _neighbor_homography(board_xy, d2_all, acc, safe_c)
    ph2_t, inb2 = _orient_and_bound(ph2, Hh, Ww)
    # unconverged accepts restart from their OWN refined quad (a fresh
    # refine resets the shift clamp); the rest from the neighbour fit
    start2 = torch.where(unconv[..., None, None], quads, ph2_t)
    attempt2 = row_active[:, None] & (unconv | (~acc & h2_ok & inb2))
    quads2 = refine_corners_mm(maps, start2.reshape(R, n_tags * 4, 2)).reshape(
        R, n_tags, 4, 2
    )
    dec2 = _decode_core_dense(family, sharp, quads2, attempt2)
    id2 = dec2["tag_id"] == exp_id[None, :]
    disp2 = torch.linalg.norm(quads2 - start2, dim=-1).amax(dim=-1)
    # the cold assist's acceptance (id match + relaxed hamming, no contrast
    # gate) plus the convergence gate
    acc2 = attempt2 & id2 & (dec2["hamming"] <= max_ham) & (disp2 < CONVERGED_MAX_DISP)
    benign = (attempt2 & ~acc2 & id2 & (disp2 < BENIGN_MAX_DISP)) | benign
    out_c = torch.where(acc2[..., None, None], dec2["corners"], out_c)
    acc = acc | acc2
    attempt = attempt | attempt2

    a4 = acc[..., None, None]
    new_c = torch.where(a4, out_c, pred_id)
    new_coast = torch.where(a4, out_c, coast_p)
    obs_v = torch.where(
        (acc & v1)[..., None, None], out_c - c1,
        gvel[:, None, None, :].expand_as(coast_v),
    )
    new_coast_v = torch.where(a4, obs_v, coast_v)
    new_age = torch.where(acc, torch.zeros_like(coast_age), coast_age + 1)
    new_carry = (c2, v2, c1, v1, new_c, acc, new_coast, new_coast_v, new_age)
    return new_carry, (out_c, acc, attempt, benign)


def wave_step(family: TagFamily, first_id: int, images, board_xy, row_active, *carry):
    """``wave_advance`` with the carry updated in place, in the argument
    order ``graphs.get`` captures: the card replays one graph per wave
    shape, its carry in the graph's own buffers.  Returns the wave's
    outputs (corners, acc, att, benign)."""
    new_carry, outs = wave_advance(family, images, board_xy, first_id, carry, row_active)
    # in tuple order each slot is read (as a source or by the step) before
    # it is overwritten: (c2, v2, c1, v1) move down, the rest are new
    for buf, value in zip(carry, new_carry):
        buf.copy_(value)
    return outs


def init_wave_carry(c1, v1, c2, v2, c3=None, v3=None):
    """The 9-tuple wave carry (numpy) from the seed frames of each row.

    c1/v1: (R, n_tags, 4, 2) / (R, n_tags) — the row's NEAREST seed frame
    (adjacent to the first frame the row processes); c2/v2 the one behind
    it in sweep order, c3/v3 the one behind that.  Triples make the
    quadratic prediction engage from the first wave.
    """
    init_age = np.where(v1, 0, MAX_COAST + 1).astype(np.int32)
    if c3 is None:
        c3 = np.zeros_like(c1)
        v3 = np.zeros_like(v1)
    return (
        c3, v3, c2, v2, c1, v1,
        c1.copy(), np.zeros_like(c1), init_age,
    )


def carry_to_device(carry, device):
    """Move a numpy wave carry onto ``device`` (float32 / bool / int32)."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in carry)


def detections_to_arrays(res, board) -> tuple:
    """{tag_id: (4,2)} -> ((n_tags, 4, 2) f32, (n_tags,) bool) carry arrays."""
    n_tags = board.n_tags
    first = board.config.first_id
    c = np.zeros((n_tags, 4, 2), np.float32)
    v = np.zeros(n_tags, bool)
    for t, cc in res.items():
        tl = int(t) - first
        if 0 <= tl < n_tags:
            c[tl] = cc
            v[tl] = True
    return c, v
