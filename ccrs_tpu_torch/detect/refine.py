"""Batched subpixel corner refinement, gather formulations.

Port of ``ccrs_tpu/detect/refine.py``: a fixed-iteration cornerSubPix-style
scheme — at the corner point q, for every window pixel p,
``gradI(p) . (p - q) = 0`` weighted least squares, i.e.
``(sum w G) q = sum w G p`` with ``G = gradI gradI^T``; one 2x2 closed-form
solve per corner per iteration.  ``refine_corners`` samples the gradient
images bilinearly around every corner; ``refine_patches`` works on PxP
patches (``patches.extract_patches``) with KLT-style precomputed maps.  The
detector refines through ``sample.refine_corners_mm`` (the same maps on
the whole frame, sampled by matmuls), which superseded both; they stay as
the reference formulations.
"""

from __future__ import annotations

import torch

# Half-window 3 (7x7): win=4 drags corners toward foreign structure
# (neighbouring data-cell edges inside the window); win=3 is unbiased and
# stable under repeated refinement (see the JAX module's measurements).
WIN = 3
#: capture radius (total-shift clamp), decoupled from the window: quad
#: corners start up to ~4 px off on the pyramid path
MAX_SHIFT = 4.0
# 10 iterations: the 1 px/iteration step clamp needs ~4 to cross a quad
# corner's bias, then a fast linear polish
ITERS = 10


def _grad(images):
    """Central-difference gradients, (..., H, W) -> (gx, gy), zero border."""
    gx = torch.zeros_like(images)
    gy = torch.zeros_like(images)
    gx[..., :, 1:-1] = (images[..., :, 2:] - images[..., :, :-2]) * 0.5
    gy[..., 1:-1, :] = (images[..., 2:, :] - images[..., :-2, :]) * 0.5
    return gx, gy


def _bilinear(imgs, x, y):
    """Sample (B, H, W) images at per-image (B, K) float positions."""
    B, H, W = imgs.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = imgs.reshape(B, H * W)
    base = y0 * W + x0

    def at(off):
        return torch.gather(flat, 1, base + off)

    return (
        at(0) * (1 - fx) * (1 - fy)
        + at(1) * fx * (1 - fy)
        + at(W) * (1 - fx) * fy
        + at(W + 1) * fx * fy
    )


def _sep_corr(maps, kx, ky):
    """Separable 'SAME' correlation over the last two dims of (N, P, P)
    with zero padding; kx/ky are 1-D taps of length 2*win+1."""
    win = (kx.shape[0] - 1) // 2
    P = maps.shape[-1]
    x = torch.nn.functional.pad(maps, (win, win, win, win))
    rows = sum(ky[k] * x[:, k : k + P, :] for k in range(2 * win + 1))
    return sum(kx[k] * rows[:, :, k : k + P] for k in range(2 * win + 1))


def _clamp_total(start, refined, max_shift: float):
    total = refined - start
    norm = torch.linalg.norm(total, dim=-1, keepdim=True)
    scale = torch.clamp(max_shift / torch.clamp(norm, min=1e-9), max=1.0)
    return start + total * scale


def _solve_step(qx, qy, a, b, d, bx, by):
    """One clamped Newton step of the 2x2 system toward (nx, ny)."""
    det = a * d - b * b
    det = torch.where(det.abs() > 1e-9, det, torch.full_like(det, 1e-9))
    nx = (d * bx - b * by) / det
    ny = (a * by - b * bx) / det
    return qx + torch.clamp(nx - qx, -1.0, 1.0), qy + torch.clamp(ny - qy, -1.0, 1.0)


def refine_patches(patches, local, win: int = WIN, iters: int = ITERS,
                   max_shift: float = MAX_SHIFT):
    """Patch-based subpixel refinement on the patches' device.

    Same fixed point as ``refine_corners`` — ``(sum w G) q = sum w G p``
    over the Gaussian window — formulated KLT-style: the window sums are
    convolutions of the gradient-product maps (gx^2, gx*gy, gy^2) with the
    separable Gaussian kernel, computed once per patch.  With p = q + o the
    right-hand side splits as

      bx(q) = qx*A(q) + qy*B(q) + [gx^2 (*) w*ox](q) + [gxgy (*) w*oy](q)
      by(q) = qx*B(q) + qy*D(q) + [gxgy (*) w*ox](q) + [gy^2 (*) w*oy](q)

    so each iteration samples 7 precomputed maps bilinearly at the current
    center and solves the 2x2.

    Args:
      patches: (N, P, P) float32.
      local: (N, 2) float32 patch-local (x, y) estimates.

    Returns (N, 2) refined patch-local positions (per-iteration step
    clamped to 1 px, total shift clamped to ``max_shift``).
    """
    N, P, _ = patches.shape
    gx, gy = _grad(patches)
    offs = torch.arange(-win, win + 1, dtype=patches.dtype, device=patches.device)
    g = torch.exp(-(offs * offs) / (2.0 * (win / 2.0) ** 2))
    go = g * offs  # first-moment taps
    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
    maps = torch.stack(
        [
            _sep_corr(gxx, g, g),  # A
            _sep_corr(gxy, g, g),  # B
            _sep_corr(gyy, g, g),  # D
            _sep_corr(gxx, go, g),  # sum w*ox*gx^2
            _sep_corr(gxy, g, go),  # sum w*oy*gx*gy
            _sep_corr(gxy, go, g),  # sum w*ox*gx*gy
            _sep_corr(gyy, g, go),  # sum w*oy*gy^2
        ],
        dim=1,
    ).reshape(N, 7, P * P)

    def bsample7(x, y):
        x = torch.clamp(x, 0.0, P - 1.001)
        y = torch.clamp(y, 0.0, P - 1.001)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        base = (y0 * P + x0)[:, None, None]
        idx = torch.cat([base, base + 1, base + P, base + P + 1], dim=2)  # (N, 1, 4)
        v = torch.gather(maps, 2, idx.expand(N, 7, 4))
        w = torch.stack(
            [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=2
        )  # (N, 1, 4)
        return torch.sum(v * w, dim=2)  # (N, 7)

    qx, qy = local[:, 0], local[:, 1]
    for _ in range(iters):
        m = bsample7(qx, qy)
        a, b, d = m[:, 0], m[:, 1], m[:, 2]
        bx = qx * a + qy * b + m[:, 3] + m[:, 4]
        by = qx * b + qy * d + m[:, 5] + m[:, 6]
        qx, qy = _solve_step(qx, qy, a, b, d, bx, by)
    return _clamp_total(local, torch.stack([qx, qy], dim=1), max_shift)


def refine_patches_2stage(patches, local):
    """The capture-and-polish setting of the fused decode
    (``decode.refine_decode_fused``): one unbiased stage, win 3, 12
    iterations, capture clamp 4.5 px (an actual win=4 pre-stage strands
    corners outside the polish basin; see the JAX module)."""
    return refine_patches(patches, local, win=3, iters=12, max_shift=4.5)


def refine_corners(images, corners, win: int = WIN, iters: int = ITERS):
    """Refine corners to subpixel accuracy.

    Args:
      images: (B, H, W) float32 grayscale.
      corners: (B, M, 2) float32 initial (x, y) estimates.

    Returns (B, M, 2) refined positions (per-iteration shift clamped to
    1 px; total shift clamped to max(win, MAX_SHIFT) px so divergent
    corners stay near their initial estimate).
    """
    B, M, _ = corners.shape
    gx, gy = _grad(images)
    offs = torch.arange(-win, win + 1, dtype=images.dtype, device=images.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    wgt = torch.exp(-(ox * ox + oy * oy) / (2.0 * (win / 2.0) ** 2))  # as cornerSubPix
    K = ox.shape[0]

    qx, qy = corners[..., 0], corners[..., 1]
    for _ in range(iters):
        x = qx[..., None] + ox  # (B, M, K)
        y = qy[..., None] + oy
        gxs = _bilinear(gx, x.reshape(B, M * K), y.reshape(B, M * K)).reshape(B, M, K)
        gys = _bilinear(gy, x.reshape(B, M * K), y.reshape(B, M * K)).reshape(B, M, K)
        a = torch.sum(wgt * gxs * gxs, dim=2)
        b = torch.sum(wgt * gxs * gys, dim=2)
        d = torch.sum(wgt * gys * gys, dim=2)
        bx = torch.sum(wgt * (gxs * gxs * x + gxs * gys * y), dim=2)
        by = torch.sum(wgt * (gxs * gys * x + gys * gys * y), dim=2)
        qx, qy = _solve_step(qx, qy, a, b, d, bx, by)
    return _clamp_total(corners, torch.stack([qx, qy], dim=-1), max(float(win), MAX_SHIFT))
