"""Adaptive threshold front-end.

Port of ``ccrs_tpu/detect/threshold.py``: tile-based adaptive thresholding
in the style of AprilTag 3 — per-tile min/max, dilated over a 3x3 tile
neighbourhood, pixels classified against the local midpoint, low-contrast
tiles forced white — followed by one white-dilation separation pass and
bit packing.

``threshold_front`` dispatches on the device of its input: a CPU tensor
goes through the plain torch version in this module, a CUDA tensor through
the hand-written kernel (``ops/threshold_cuda.py``), which raises rather
than falls back.  Every value in this pipeline is exact in float32, so the
two agree bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TILE = 4
MIN_CONTRAST = 20.0  # on a 0..255 scale


def _pool3(v, op: str):
    """3x3 SAME window over (B, h, w); out-of-range cells are ignored
    (max_pool2d pads with -inf, the reference's reduce_window init)."""
    x = v[:, None]
    if op == "max":
        return F.max_pool2d(x, 3, stride=1, padding=1)[:, 0]
    return -F.max_pool2d(-x, 3, stride=1, padding=1)[:, 0]


def adaptive_threshold(
    images, tile: int = TILE, min_contrast: float = MIN_CONTRAST,
    separate: bool = True,
):
    """Binarize a (B, H, W) batch (uint8 or float32, 0..255; H, W
    divisible by ``tile``).

    ``separate`` applies one white dilation (3x3 OR, False padding) after
    thresholding: it severs the diagonal bridges between tag corners and
    the Kalibr corner squares (see the JAX package's docstring).

    Returns (B, H, W) uint8 — 1 white, 0 black.
    """
    B, H, W = images.shape
    x = images.to(torch.float32)
    t = x.reshape(B, H // tile, tile, W // tile, tile)
    tmin = t.amin(dim=(2, 4))
    tmax = t.amax(dim=(2, 4))
    nmin = _pool3(tmin, "min")
    nmax = _pool3(tmax, "max")
    contrast_ok = (nmax - nmin) >= min_contrast
    thresh = (nmin + nmax) * 0.5

    def up(v):
        return v.repeat_interleave(tile, dim=1).repeat_interleave(tile, dim=2)

    binary = x > up(thresh)
    binary = binary | ~up(contrast_ok)  # low contrast -> white
    if separate:
        binary = F.max_pool2d(
            binary[:, None].to(torch.float32), 3, stride=1, padding=1
        )[:, 0] > 0
    return binary.to(torch.uint8)


def _pack(binary):
    """(B, H, W) {0,1} -> (B, H, W//8) uint8, MSB first."""
    B, H, W = binary.shape
    bits = binary.reshape(B, H, W // 8, 8).to(torch.int32)
    weights = torch.tensor(
        [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=binary.device
    )
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def adaptive_threshold_packed2(
    images, tile: int = TILE, min_contrast: float = MIN_CONTRAST
):
    """Two erosion levels in one pass: (B, 2, H, W//8) packed binaries.

    Level 0 = one white dilation (the standard separation pass); level 1 =
    two dilations.  Anti-aliased Kalibr corner-square bridges grow with the
    tag scale: at ~140 px tags they survive a single erosion and merge the
    tag into a cross, so quad extraction can run on both levels.  (The
    detector computes level 1 on the host from the downloaded level-0
    bitmap instead, ``detector._dilate_white_host``.)"""
    b1 = adaptive_threshold(images, tile, min_contrast, separate=True)
    b2 = (F.max_pool2d(b1[:, None].to(torch.float32), 3, stride=1, padding=1)[:, 0] > 0).to(
        torch.uint8
    )
    return torch.stack([_pack(b1), _pack(b2)], dim=1)


def _pool2(images):
    """2x2 mean pyramid level in float32; odd trailing rows/cols drop.
    The sum order is fixed so the CUDA kernel can match it exactly."""
    B, H, W = images.shape
    x = images[:, : H // 2 * 2, : W // 2 * 2].to(torch.float32)
    return ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
            + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) * 0.25


def pad_to_tile(img, tile: int = TILE):
    """Pad (..., H, W) on the bottom/right with white (255): rows to a
    multiple of ``tile``, columns to a multiple of lcm(tile, 8) so the
    packed-bits output stays aligned.  Returns (padded, H, W)."""
    H, W = img.shape[-2], img.shape[-1]
    wmul = tile * 8 // math.gcd(tile, 8)
    ph = (-H) % tile
    pw = (-W) % wmul
    if ph == 0 and pw == 0:
        return img, H, W
    return F.pad(img, (0, pw, 0, ph), mode="constant", value=255), H, W


def threshold_front_plain(
    images, scale: int = 1, tile: int = TILE, min_contrast: float = MIN_CONTRAST
):
    """Plain torch twin of the kernel: optional 2x2-mean pyramid level +
    white pad-to-tile + adaptive threshold + separation + bit packing.
    Returns (B, sH_pad, sW_pad/8) uint8."""
    if scale == 2:
        images = _pool2(images)
    images, _, _ = pad_to_tile(images, tile)
    return _pack(adaptive_threshold(images, tile, min_contrast, separate=True))


def threshold_front(
    images, scale: int = 1, tile: int = TILE, min_contrast: float = MIN_CONTRAST
):
    """The detector's candidate front-end on a (B, H, W) uint8/float32
    batch: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor.  Returns (B, sH_pad, sW_pad/8) uint8 on the input's device."""
    if images.device.type == "cuda":
        from ..ops.threshold_cuda import threshold_front_cuda

        return threshold_front_cuda(images, scale, tile, min_contrast)
    if images.device.type != "cpu":
        raise ValueError(f"threshold_front: unsupported device {images.device}")
    return threshold_front_plain(images, scale, tile, min_contrast)
