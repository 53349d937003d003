"""Batched tag decoding: quad -> homography -> bit sampling -> code match.

Port of the dense path of ``ccrs_tpu/detect/decode.py``: closed-form
unit-square homographies (Heckbert), bilinear bit sampling on the
unsharp-masked frame, a local black/white threshold from the tag's own
border ring and the surrounding white ring, and code matching as one
(Q, nbits) x (nbits, 4*ncodes) matmul — hamming distance through the ±1
dot-product identity (score = nbits - 2*hamming).  The ±1 products and
their <= 64-term sums are exact in float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .families import TagFamily

MIN_DECODE_CONTRAST = 20.0
_KALIBR_PERM = (1, 0, 3, 2)


def _unit_square_homography(quad):
    """Heckbert projective map from the unit square to a quad.

    quad: (..., 4, 2) corners ordered (0,0),(1,0),(1,1),(0,1).
    Returns H (..., 3, 3) with x = H @ (u,v,1).
    """
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    g = (sx * dy2 - sy * dx2) / den
    h = (dx1 * sy - dy1 * sx) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    one = torch.ones_like(a)
    return torch.stack(
        [torch.stack([a, b, x0], -1), torch.stack([d, e, y0], -1),
         torch.stack([g, h, one], -1)],
        -2,
    )


def _apply_h(H, uv):
    """(..., 3, 3) x (S, 2) -> (..., S, 2), written out per row so the
    sum order is the same on every device."""
    u, v = uv[:, 0], uv[:, 1]

    def row(k):
        return (u * H[..., k, 0, None] + v * H[..., k, 1, None]) + H[..., k, 2, None]

    px, py, pz = row(0), row(1), row(2)
    z = torch.where(pz.abs() > 1e-12, pz, torch.full_like(pz, 1e-12))
    return torch.stack([px / z, py / z], dim=-1)


@lru_cache(maxsize=None)
def _sample_grids(family: TagFamily):
    """Static (unit-square) sample positions as float32 numpy arrays: data
    cells (3x3 subsamples each), black refs (inner border ring), white refs
    (outside the quad)."""
    T = family.total_size
    s = family.size
    b = family.border
    jj, ii = np.meshgrid(np.arange(s), np.arange(s))
    centers = np.stack([(b + jj).ravel(), (b + ii).ravel()], -1).astype(np.float64)
    sub = np.array([0.3, 0.5, 0.7])
    su, sv = np.meshgrid(sub, sub)
    subs = np.stack([su.ravel(), sv.ravel()], -1)  # (9,2)
    data_uv = ((centers[:, None, :] + subs[None, :, :]) / T).reshape(-1, 2)
    # black refs: ring just inside the data area (layer b-1)
    layer = b - 1
    ring = []
    for i in range(T):
        for j in range(T):
            if min(i, j, T - 1 - i, T - 1 - j) == layer:
                ring.append([(j + 0.5) / T, (i + 0.5) / T])
    black_uv = np.asarray(ring)
    # white refs: 0.75 cells outside each edge at 3 positions
    off = 0.75 / T
    white_uv = []
    for t in (0.25, 0.5, 0.75):
        white_uv += [[t, -off], [t, 1 + off], [-off, t], [1 + off, t]]
    white_uv = np.asarray(white_uv)
    return (
        data_uv.astype(np.float32),
        black_uv.astype(np.float32),
        white_uv.astype(np.float32),
    )


def _decode_core_dense(family: TagFamily, sharp, quads, qvalid):
    """Per-image dense decode: quads (B, M, 4, 2) float32, qvalid (B, M)
    bool, ``sharp`` the unsharp-masked float32 frames (B, H, W).

    Returns a dict of (B, M) tag_id / rotation / hamming / valid /
    contrast_ok and (B, M, 4, 2) corners in the tag's canonical order
    (corner 0 = board corner id tag*4+0)."""
    from .sample import sample_bilinear_mm

    dev = quads.device
    data_uv, black_uv, white_uv = _sample_grids(family)
    n_data, n_black = data_uv.shape[0], black_uv.shape[0]
    all_uv = torch.as_tensor(
        np.concatenate([data_uv, black_uv, white_uv], axis=0), device=dev
    )
    codes = torch.as_tensor(
        family.rotated_codes, dtype=torch.float32, device=dev
    )
    nbits = codes.shape[1]
    B, M = quads.shape[:2]
    S = all_uv.shape[0]

    pos = _apply_h(_unit_square_homography(quads), all_uv)  # (B, M, S, 2)
    vals = sample_bilinear_mm(
        sharp, pos[..., 0].reshape(B, M * S), pos[..., 1].reshape(B, M * S)
    ).reshape(B, M, S)
    dpix = vals[:, :, :n_data].reshape(B, M, -1, 9).mean(dim=3)
    black = vals[:, :, n_data : n_data + n_black].mean(dim=2)
    white = vals[:, :, n_data + n_black :].mean(dim=2)
    thr = 0.5 * (black + white)
    bits = torch.where(
        dpix > thr[..., None], torch.ones_like(dpix), -torch.ones_like(dpix)
    )
    contrast_ok = (white - black) > MIN_DECODE_CONTRAST
    scores = (bits.reshape(B * M, nbits) @ codes.T).reshape(B, M, -1)
    # ties resolve to the first index, as jnp.argmax does
    best = torch.argmax(scores, dim=2)
    hamming = (
        (nbits - torch.gather(scores, 2, best[..., None])[..., 0]) / 2
    ).to(torch.int32)
    tag_id = best // 4
    rotation = best % 4
    valid = qvalid & contrast_ok & (hamming <= family.max_hamming)
    perm = torch.tensor(_KALIBR_PERM, dtype=torch.int64, device=dev)
    idx = (perm[None, None, :] - rotation[..., None]) % 4
    corners = torch.gather(quads, 2, idx[..., None].expand(B, M, 4, 2))
    return {
        "tag_id": tag_id,
        "rotation": rotation,
        "hamming": hamming,
        "valid": valid,
        "contrast_ok": contrast_ok,
        "corners": corners,
    }


def refine_decode_fused_dense(
    family: TagFamily, images, quads, qvalid, do_refine: bool = True,
    sharp=None, maps=None,
):
    """Refine + decode dense per-frame quad buffers: quads (B, M, 4, 2)
    float32, qvalid (B, M) bool, images the ORIGINAL (B, H, W) frames on
    the same device.

    ``sharp`` / ``maps`` reuse a previous call's unsharp-masked frames and
    KLT maps (the board-assist pass decodes the same chunk again).
    Returns the ``_decode_core_dense`` dict plus "sharp" and "maps".
    """
    from .sample import build_klt_maps, refine_corners_mm, unsharp_mm

    images = images.to(torch.float32)
    B, M = quads.shape[:2]
    if do_refine:
        if maps is None:
            maps = build_klt_maps(images)
        quads = refine_corners_mm(
            maps, quads.reshape(B, M * 4, 2)
        ).reshape(B, M, 4, 2)
    if sharp is None:
        sharp = unsharp_mm(images)
    out = _decode_core_dense(family, sharp, quads, qvalid)
    out["sharp"] = sharp
    out["maps"] = maps
    return out
