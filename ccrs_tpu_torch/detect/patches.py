"""Corner-patch extraction on the frames' device.

Port of ``ccrs_tpu/detect/patches.py``: each candidate corner's PxP
neighbourhood is gathered where the frames live, so that only the patches
(about 1 KB per corner) reach a patch-based refinement
(``refine.refine_patches``, ``quads.refine_corners_patches_native``).  The
detector's dense path (``sample.refine_corners_mm``) superseded it; it
stays for callers that refine on patches.
"""

from __future__ import annotations

import torch

PATCH = 18  # window 9x9 around a center that may wander +-4 px


def extract_patches(images, corners, qframe, P: int = PATCH, as_u8: bool = False):
    """Gather PxP patches around corners.

    Args:
      images: (B, H, W) float32.
      corners: (Q, 2) float32 (x, y) image coordinates.
      qframe: (Q,) integer frame index per corner.
      as_u8: quantize the patches to uint8 (a quarter of the bytes; a real
        camera's bit depth, so subpixel refinement loses nothing that
        matters).

    Returns (patches (Q, P, P), local (Q, 2) patch-space coordinates,
    offset (Q, 2) patch origin in image space).
    """
    B, H, W = images.shape
    half = P // 2
    bx = torch.clamp(torch.round(corners[:, 0]).to(torch.int64) - half, 0, W - P)
    by = torch.clamp(torch.round(corners[:, 1]).to(torch.int64) - half, 0, H - P)
    d = torch.arange(P, dtype=torch.int64, device=images.device)
    idx = (
        qframe.to(torch.int64)[:, None, None] * (H * W)
        + (by[:, None, None] + d[None, :, None]) * W
        + (bx[:, None, None] + d[None, None, :])
    )
    patches = images.reshape(-1)[idx]
    if as_u8:
        patches = torch.clamp(torch.round(patches), 0, 255).to(torch.uint8)
    offset = torch.stack([bx, by], dim=1).to(corners.dtype)
    return patches, corners - offset, offset
