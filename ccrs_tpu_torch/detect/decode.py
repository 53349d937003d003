"""Batched tag decoding: quad -> homography -> bit sampling -> code match.

Port of ``ccrs_tpu/detect/decode.py``.  The dense path, which the
detector runs (``refine_decode_fused_dense``): closed-form
unit-square homographies (Heckbert), bilinear bit sampling on the
unsharp-masked frame, a local black/white threshold from the tag's own
border ring and the surrounding white ring, and code matching as one
(Q, nbits) x (nbits, 4*ncodes) matmul — hamming distance through the ±1
dot-product identity (score = nbits - 2*hamming).  The ±1 products and
their <= 64-term sums are exact in float32.  The KLT maps, the corner
refinement, the unsharp mask and the bit sampling come from ``sample.py``,
whose branch (banded and hat-weight products, or tap loops and gathers)
follows the frames' device: no caller here picks one.

The compact path it superseded is kept beside it: ``unsharp``,
``decode_quads_compact`` over a (Q, 4, 2) quad list with a frame index per
quad (gathers instead of per-image matmuls), and ``refine_decode_fused``,
which refines on corner patches (``patches.py``, ``refine.py``) first.
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


@lru_cache(maxsize=None)
def _dense_constants(family: TagFamily, device: torch.device):
    """The dense decode's constant tensors on ``device``: the unit-square
    sample positions (data, black, white), the rotated codes as float32
    and the Kalibr corner permutation.  Made once per device, so that a
    decode queued on the card uploads nothing from pageable memory (such
    an upload waits for the whole stream)."""
    data_uv, black_uv, white_uv = _sample_grids(family)
    all_uv = torch.as_tensor(
        np.concatenate([data_uv, black_uv, white_uv], axis=0), device=device
    )
    codes = torch.as_tensor(family.rotated_codes, dtype=torch.float32, device=device)
    perm = torch.tensor(_KALIBR_PERM, dtype=torch.int64, device=device)
    return all_uv, codes, perm


def _decode_core_dense(family: TagFamily, sharp, quads, qvalid):
    """Per-image dense decode: quads (B, M, 4, 2) float32, qvalid (B, M)
    bool, ``sharp`` the unsharp-masked float32 frames (B, H, W).

    Returns a dict of (B, M) tag_id / rotation / hamming / valid /
    contrast_ok and (B, M, 4, 2) corners in the tag's canonical order
    (corner 0 = board corner id tag*4+0)."""
    from .sample import sample_bilinear_mm

    data_uv, black_uv, _ = _sample_grids(family)
    n_data, n_black = data_uv.shape[0], black_uv.shape[0]
    all_uv, codes, perm = _dense_constants(family, quads.device)
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


# --------------------------------------------------------------------------
# the compact (quad list + frame index) path
# --------------------------------------------------------------------------


def unsharp(images, amount: float = 1.2, sigma: float = 1.2):
    """Unsharp-mask a (B, H, W) float32 batch (separable 7-tap Gaussian,
    edge padding).

    For DECODE BIT SAMPLING only: optical blur makes the ~3 px data cells
    of small or far tags bleed into each other and flips bits.  Corner
    refinement keeps the original image (sharpening adds gradient ringing
    that would bias subpixel corners).
    """
    r = torch.arange(-3, 4, dtype=torch.float32, device=images.device)
    k = torch.exp(-(r * r) / (2.0 * sigma * sigma))
    k = k / torch.sum(k)
    x = torch.nn.functional.pad(images[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    H, W = images.shape[1:]
    # separable blur via shifted sums (7 taps per axis)
    rows = sum(k[i] * x[:, i : i + H, :] for i in range(7))
    blur = sum(k[i] * rows[:, :, i : i + W] for i in range(7))
    return images + amount * (images - blur)


def _decode_core(family: TagFamily, images, quads, qframe, qvalid):
    """Decode a compact quad list (see ``decode_quads_compact``);
    ``images`` must be decode-ready (sharpened, float32)."""
    dev = quads.device
    data_uv, black_uv, white_uv = _sample_grids(family)
    n_data, n_black = data_uv.shape[0], black_uv.shape[0]
    all_uv = torch.as_tensor(np.concatenate([data_uv, black_uv, white_uv], axis=0), device=dev)
    codes = torch.as_tensor(family.rotated_codes, dtype=torch.float32, device=dev)
    nbits = codes.shape[1]
    B, H, W = images.shape
    flat = images.reshape(-1)

    pos = _apply_h(_unit_square_homography(quads), all_uv)  # (Q, S, 2)
    x = torch.clamp(pos[..., 0], 0.0, W - 1.001)
    y = torch.clamp(pos[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    base = qframe.to(torch.int64)[:, None] * (H * W) + y0 * W + x0
    vals = (
        flat[base] * (1 - fx) * (1 - fy)
        + flat[base + 1] * fx * (1 - fy)
        + flat[base + W] * (1 - fx) * fy
        + flat[base + W + 1] * fx * fy
    )  # (Q, S)
    Q = quads.shape[0]
    dpix = vals[:, :n_data].reshape(Q, -1, 9).mean(dim=2)
    black = vals[:, n_data : n_data + n_black].mean(dim=1)
    white = vals[:, n_data + n_black :].mean(dim=1)
    thr = 0.5 * (black + white)
    bits = torch.where(dpix > thr[:, None], torch.ones_like(dpix), -torch.ones_like(dpix))
    contrast_ok = (white - black) > MIN_DECODE_CONTRAST
    scores = bits @ codes.T
    best = torch.argmax(scores, dim=1)  # ties: the first index, as jnp.argmax
    hamming = ((nbits - torch.gather(scores, 1, best[:, None])[:, 0]) / 2).to(torch.int32)
    tag_id = best // 4
    rotation = best % 4
    valid = qvalid & contrast_ok & (hamming <= family.max_hamming)
    perm = torch.tensor(_KALIBR_PERM, dtype=torch.int64, device=dev)
    idx = (perm[None, :] - rotation[:, None]) % 4
    corners = torch.gather(quads, 1, idx[..., None].expand(Q, 4, 2))
    return {
        "tag_id": tag_id,
        "rotation": rotation,
        "hamming": hamming,
        "valid": valid,
        # separate, so that id-matching callers can relax the hamming
        # budget without losing the contrast gate
        "contrast_ok": contrast_ok,
        "corners": corners,
    }


def decode_quads_compact(family: TagFamily, images, quads, qframe, qvalid):
    """Decode a COMPACT quad list.

    Args:
      images: (B, H, W) float32, already sharpened for bit sampling
        (``unsharp``).
      quads: (Q, 4, 2) corners; rows past the real count are padding.
      qframe: (Q,) integer frame index per quad.
      qvalid: (Q,) bool padding mask.

    Returns a dict of (Q,) tag_id / rotation / hamming / valid /
    contrast_ok and (Q, 4, 2) canonical corners (corner 0 = the tag's
    canonical top-left, board corner id tag*4+0).
    """
    return _decode_core(family, images, quads, qframe, qvalid)


def refine_decode_fused(
    family: TagFamily, images, quads, qframe, qvalid, do_refine: bool = True,
    sharp=None,
):
    """The compact path's whole post-threshold detect step: patch gather ->
    subpixel corner refine -> unsharp -> bit-sample decode.

    Args:
      images: (B, H, W) uint8/float32 ORIGINAL (un-sharpened) frames;
        corner refinement samples these.
      quads / qframe / qvalid: the compact candidate list of
        ``decode_quads_compact``.
      sharp: optional pre-sharpened (B, H, W) float32 frames for the bit
        sampling — a previous call's ``out["sharp"]``, so a follow-up
        decode of the same chunk skips the unsharp mask.

    Returns the decode dict plus "sharp".
    """
    from .patches import extract_patches
    from .refine import refine_patches_2stage

    images = images.to(torch.float32)
    if do_refine:
        corners = quads.reshape(-1, 2)
        cframe = torch.repeat_interleave(qframe.to(torch.int64), 4)
        patches, local, offset = extract_patches(images, corners, cframe)
        quads = (refine_patches_2stage(patches, local) + offset).reshape(quads.shape)
    if sharp is None:
        sharp = unsharp(images)
    out = _decode_core(family, sharp, quads, qframe, qvalid)
    out["sharp"] = sharp
    return out
