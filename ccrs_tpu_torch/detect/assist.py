"""Board-assisted tag recovery (second detection pass).

Port of ``ccrs_tpu/detect/assist.py`` (host numpy; the decode of the
predicted quads goes through ``decode.refine_decode_fused_dense`` on the
frames' device, driven by the detector).

A calibration-specific capability beyond the reference detector: once some
tags of a frame decoded, the board's known geometry pins down where every
OTHER tag must be.  For each missing tag we fit a local homography from the
nearest detected tags' corners (local fits track fisheye curvature far
better than one global H), predict its quad, subpixel-refine it on the
image, and re-decode — accepting only if the decoded id matches the
prediction (a much stronger test than open-set matching, so a slightly
higher hamming budget is safe).

All predicted quads of a chunk decode in one call, like the primary
pass.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..board import Board
from .families import TagFamily

ASSIST_EXTRA_HAMMING = 2
MIN_TAGS_FOR_ASSIST = 4
N_NEIGHBORS = 4
_BUCKET = 8  # small rung of the per-frame candidate bucket ladder


def _fit_h_batch(src: np.ndarray, dst: np.ndarray):
    """Batched DLT: src/dst (Q, n, 2) -> (H (Q, 3, 3), valid (Q,)).

    One LAPACK call over the whole candidate set — the per-candidate
    python/SVD loop was the assist pass's main host cost at 128 frames.
    """
    Q, n, _ = src.shape
    sm = src.mean(1)  # (Q,2)
    ss = src.reshape(Q, -1).std(1) + 1e-12
    dm = dst.mean(1)
    ds = dst.reshape(Q, -1).std(1) + 1e-12
    s = (src - sm[:, None]) / ss[:, None, None]
    d = (dst - dm[:, None]) / ds[:, None, None]
    A = np.zeros((Q, 2 * n, 9))
    A[:, 0::2, 0:2] = s
    A[:, 0::2, 2] = 1
    A[:, 0::2, 6:8] = -d[:, :, :1] * s
    A[:, 0::2, 8] = -d[:, :, 0]
    A[:, 1::2, 3:5] = s
    A[:, 1::2, 5] = 1
    A[:, 1::2, 6:8] = -d[:, :, 1:2] * s
    A[:, 1::2, 8] = -d[:, :, 1]
    try:
        _, sv, Vt = np.linalg.svd(A, full_matrices=False)
        bad = np.zeros(Q, bool)
    except np.linalg.LinAlgError:  # pragma: no cover - per-item fallback
        sv = np.zeros((Q, 9))
        Vt = np.zeros((Q, 9, 9))
        bad = np.ones(Q, bool)
        for q in range(Q):
            try:
                _, sv[q], Vt[q] = np.linalg.svd(A[q], full_matrices=False)
                bad[q] = False
            except np.linalg.LinAlgError:
                pass
    valid = (~bad) & (sv[:, -2] >= 1e-10)
    Hn = Vt[:, -1].reshape(Q, 3, 3)
    Ts = np.zeros((Q, 3, 3))
    Ts[:, 0, 0] = Ts[:, 1, 1] = 1.0 / ss
    Ts[:, 0, 2] = -sm[:, 0] / ss
    Ts[:, 1, 2] = -sm[:, 1] / ss
    Ts[:, 2, 2] = 1.0
    Td = np.zeros((Q, 3, 3))
    Td[:, 0, 0] = Td[:, 1, 1] = ds
    Td[:, 0, 2] = dm[:, 0]
    Td[:, 1, 2] = dm[:, 1]
    Td[:, 2, 2] = 1.0
    return Td @ Hn @ Ts, valid


def assist_candidates(board: Board, results: List[Dict[int, np.ndarray]],
                      W: int, H: int):
    """Host half 1: predict quads for missing tags from decoded neighbors.

    Returns DENSE per-frame candidate buffers (quads (B, Ma, 4, 2),
    valid (B, Ma), expected_id (B, Ma) int32) sized to a sticky grow-only
    bucket Ma — the layout decode.refine_decode_fused_dense consumes —
    or (None, None, None) when no frame has work to do."""
    first = board.config.first_id
    n_tags = board.n_tags
    centers = board.p3d.reshape(n_tags, 4, 3)[:, :, :2].mean(1)

    corners_xy = board.p3d.reshape(n_tags, 4, 3)[:, :, :2]  # (n_tags, 4, 2)
    src_l, dst_l, tgt_l, frame_l = [], [], [], []
    for b, dets in enumerate(results):
        local = {t - first: c for t, c in dets.items() if 0 <= t - first < n_tags}
        if len(local) < MIN_TAGS_FOR_ASSIST or len(local) == n_tags:
            continue
        det_ids = np.array(sorted(local))
        det_corners = np.stack([local[int(u)] for u in det_ids])  # (nd, 4, 2)
        missing = np.setdiff1d(np.arange(n_tags), det_ids)
        # 4 nearest decoded tags per missing tag, ascending distance
        d2 = ((centers[det_ids][None] - centers[missing][:, None]) ** 2).sum(-1)
        near = np.argsort(d2, axis=1)[:, :N_NEIGHBORS]  # (nm, k) into det_ids
        src_l.append(corners_xy[det_ids[near]].reshape(len(missing), -1, 2))
        dst_l.append(det_corners[near].reshape(len(missing), -1, 2))
        tgt_l.append(missing)
        frame_l.append(np.full(len(missing), b, np.int32))
    if not src_l:
        return None, None, None
    src = np.concatenate(src_l)  # (Q, 4k, 2)
    dst = np.concatenate(dst_l)
    tgt = np.concatenate(tgt_l)  # (Q,) local tag index
    frm = np.concatenate(frame_l)

    Hm, ok = _fit_h_batch(src, dst)  # one batched SVD for all candidates
    quad = np.einsum("qij,qnj->qni", Hm[:, :, :2], corners_xy[tgt]) + Hm[
        :, None, :, 2
    ]
    zq = quad[:, :, 2]
    zq = np.where(np.abs(zq) > 1e-12, zq, 1e-12)
    quad = quad[:, :, :2] / zq[:, :, None]  # (Q, 4, 2)
    # decode expects clockwise traversal in image coordinates (the Kalibr
    # board-corner order comes out counter-clockwise)
    x, y = quad[:, :, 0], quad[:, :, 1]
    area2 = np.einsum("qn,qn->q", x, np.roll(y, -1, 1)) - np.einsum(
        "qn,qn->q", np.roll(x, -1, 1), y
    )
    quad = np.where((area2 < 0)[:, None, None], quad[:, ::-1], quad)
    ok &= (
        (quad[:, :, 0].min(1) >= 1)
        & (quad[:, :, 1].min(1) >= 1)
        & (quad[:, :, 0].max(1) <= W - 2)
        & (quad[:, :, 1].max(1) <= H - 2)
        # degenerate/too-small predictions are not worth decoding
        & (0.5 * np.abs(area2) >= 49)
    )
    keep = np.flatnonzero(ok)
    if keep.size == 0:
        return None, None, None

    # dense per-frame buffers on a TWO-RUNG bucket ladder: healthy chunks
    # (a couple of missing tags per frame) use the small rung; any frame
    # with a partially-visible board jumps straight to n_tags.  A single
    # grow-only bucket would ratchet to n_tags on the first sparse frame
    # and pad every later healthy chunk's decode ~4x.
    B = len(results)
    per_frame = np.bincount(frm[keep], minlength=B)
    small = min(_BUCKET, n_tags)
    Ma = small if int(per_frame.max()) <= small else n_tags
    quads = np.zeros((B, Ma, 4, 2), np.float32)
    valid = np.zeros((B, Ma), bool)
    # padding slots carry expected id -1: the merge's id-match test can
    # then run over the whole dense buffer without a separate mask
    exp_id = np.full((B, Ma), -1, np.int32)
    slot = np.zeros(B, np.int32)
    for q in keep:
        b = int(frm[q])
        s = slot[b]
        if s >= Ma:  # pragma: no cover - bucket guarantees capacity
            continue
        quads[b, s] = quad[q]
        valid[b, s] = True
        exp_id[b, s] = int(tgt[q]) + first
        slot[b] = s + 1
    return quads, valid, exp_id


def assist_merge(
    family: TagFamily,
    exp_id,
    out,
    results: List[Dict[int, np.ndarray]],
) -> int:
    """Host half 2: accept decoded candidates whose id matches the
    prediction (within the relaxed hamming budget); augments ``results``
    in place and returns the number of recovered tags."""
    tag_id = out["tag_id"].cpu().numpy()
    hamming = out["hamming"].cpu().numpy()
    corners = out["corners"].cpu().numpy()

    recovered = 0
    budget = family.max_hamming + ASSIST_EXTRA_HAMMING
    # id match + relaxed hamming, NO contrast gate (the id match is the
    # strong test; oblique rim tags legitimately run low-contrast) —
    # padding slots never match their expected id of -1
    for b, s in zip(*np.nonzero((tag_id == exp_id) & (hamming <= budget))):
        t_expect = int(exp_id[b, s])
        if t_expect not in results[b]:
            results[b][t_expect] = corners[b, s].copy()
            recovered += 1
    return recovered


def recover_missing_tags(
    family: TagFamily,
    board: Board,
    images,
    results: List[Dict[int, np.ndarray]],
    do_refine: bool = True,
) -> int:
    """Predict + refine + decode + merge in one step (a convenience
    wrapper; the detector calls the two halves itself, around a decode
    that reuses the primary pass's sharpened frames and maps).

    ``images``: (B, H, W) tensor of ORIGINAL frames (uint8 or float32) on
    the device the decode runs on.  Augments ``results`` in place and
    returns the number of recovered tags.
    """
    from .decode import refine_decode_fused_dense

    B, H, W = images.shape
    quads, valid, exp_id = assist_candidates(board, results, W, H)
    if quads is None:
        return 0
    out = refine_decode_fused_dense(
        family, images, torch.as_tensor(quads, device=images.device),
        torch.as_tensor(valid, device=images.device), do_refine=do_refine,
    )
    return assist_merge(family, exp_id, out, results)
