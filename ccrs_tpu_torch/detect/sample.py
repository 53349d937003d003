"""Image sampling for corner refinement and decoding: tap loops + gathers.

Port of the gather / tap-loop branch of ``ccrs_tpu/detect/sample.py`` (the
branch the JAX package takes on the CPU).  The JAX package's other branch
recasts every sampling pattern as bf16 hat-weight matmuls for the TPU's
matrix unit; that formulation is not ported.  The GPU runs the same
float32 gathers and 7-tap loops as the CPU, so the card computes what the
JAX CPU reference computes.

- ``unsharp_mm``: 7-tap separable Gaussian unsharp mask (replicate border);
- ``build_klt_maps``: the 7 structure-tensor window sums of the subpixel
  corner refinement (zero border);
- ``refine_corners_mm``: 12 Newton steps per corner against the maps;
- ``sample_bilinear_mm``: 4-tap bilinear gather at per-image positions.

All gather indices are clipped to the image first: torch raises (and CUDA
asserts) on out-of-range indices where XLA clamps silently.
"""

from __future__ import annotations

import numpy as np
import torch

#: refine window parameters (win=3 Gaussian; see ccrs_tpu/detect/refine.py)
WIN = 3
MAX_SHIFT = 4.5
ITERS = 12

_offs = np.arange(-WIN, WIN + 1, dtype=np.float32)
_G_TAPS = np.exp(-(_offs * _offs) / (2.0 * (WIN / 2.0) ** 2)).astype(np.float32)
_GO_TAPS = (_G_TAPS * _offs).astype(np.float32)

_r = np.arange(-3, 4, dtype=np.float32)
_BLUR_TAPS = np.exp(-(_r * _r) / (2.0 * 1.2 * 1.2)).astype(np.float32)
_BLUR_TAPS /= _BLUR_TAPS.sum()


def _tap_corr(x, taps: np.ndarray, dim: int, edge: bool):
    """out[u] = sum_t taps[t+R] x[u + t] along ``dim``, with replicate
    (edge=True) or zero (edge=False) boundary."""
    R = (len(taps) - 1) // 2
    n = x.shape[dim]
    if edge:
        idx = torch.arange(-R, n + R, device=x.device).clamp(0, n - 1)
        xp = x.index_select(dim, idx)
    else:
        zshape = list(x.shape)
        zshape[dim] = R
        z = torch.zeros(zshape, dtype=x.dtype, device=x.device)
        xp = torch.cat([z, x, z], dim=dim)
    out = None
    for i, w in enumerate(taps):
        term = float(w) * xp.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def unsharp_mm(images, amount: float = 1.2):
    """Unsharp mask of a (B, H, W) batch (decode bit sampling only: it keeps
    the ~3 px data cells of far tags apart).  Returns float32."""
    images = images.to(torch.float32)
    blur = _tap_corr(_tap_corr(images, _BLUR_TAPS, 1, True), _BLUR_TAPS, 2, True)
    return images + amount * (images - blur)


def build_klt_maps(images):
    """The 7 structure-tensor maps on the full image: A=w(*)gx^2,
    B=w(*)gxgy, D=w(*)gy^2 and the four first-moment maps
    (w*ox*gx^2, w*oy*gxgy, w*ox*gxgy, w*oy*gy^2).

    Returns (B, 7, H, W) float32; window sums use a zero border."""
    f = images.to(torch.float32)
    gx = torch.zeros_like(f)
    gy = torch.zeros_like(f)
    gx[:, :, 1:-1] = (f[:, :, 2:] - f[:, :, :-2]) * 0.5
    gy[:, 1:-1, :] = (f[:, 2:, :] - f[:, :-2, :]) * 0.5
    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy

    def cy(x, t):
        return _tap_corr(x, t, 1, False)

    def cx(x, t):
        return _tap_corr(x, t, 2, False)

    # y (row) pass once per (source, ky) pair, then x (col) passes
    gxx_g = cy(gxx, _G_TAPS)
    gxy_g = cy(gxy, _G_TAPS)
    gyy_g = cy(gyy, _G_TAPS)
    gxy_go = cy(gxy, _GO_TAPS)
    gyy_go = cy(gyy, _GO_TAPS)
    return torch.stack(
        [
            cx(gxx_g, _G_TAPS),    # A
            cx(gxy_g, _G_TAPS),    # B
            cx(gyy_g, _G_TAPS),    # D
            cx(gxx_g, _GO_TAPS),   # sum w*ox*gx^2
            cx(gxy_go, _G_TAPS),   # sum w*oy*gx*gy
            cx(gxy_g, _GO_TAPS),   # sum w*ox*gx*gy
            cx(gyy_go, _G_TAPS),   # sum w*oy*gy^2
        ],
        dim=1,
    )


def _floor_taps(x, y, H: int, W: int):
    """Bilinear-tap indices/fractions, positions clipped to the image so
    the +1 taps stay in range."""
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0.to(torch.int64), y0.to(torch.int64), x - x0, y - y0


def _sample_maps_gather(maps, qx, qy):
    """Bilinear-gather the 7 maps (B, C, H, W) at (B, M) points ->
    (B, M, C)."""
    B, C, H, W = maps.shape
    M = qx.shape[1]
    x0, y0, fx, fy = _floor_taps(qx, qy, H, W)
    flat = maps.reshape(B, C, H * W)

    def tap(dy, dx):
        idx = (y0 + dy) * W + (x0 + dx)
        return torch.gather(flat, 2, idx[:, None, :].expand(B, C, M))

    v = (
        tap(0, 0) * ((1 - fy) * (1 - fx))[:, None, :]
        + tap(0, 1) * ((1 - fy) * fx)[:, None, :]
        + tap(1, 0) * (fy * (1 - fx))[:, None, :]
        + tap(1, 1) * (fy * fx)[:, None, :]
    )
    return v.transpose(1, 2)


def refine_corners_mm(maps, corners, iters: int = ITERS,
                      max_shift: float = MAX_SHIFT):
    """Subpixel-refine (B, M, 2) float32 (x, y) corners against the KLT
    maps: Newton steps with a 1 px/iteration clamp, then a total-shift
    clamp.  Returns (B, M, 2)."""
    c = corners
    for _ in range(iters):
        qx, qy = c[..., 0], c[..., 1]
        m = _sample_maps_gather(maps, qx, qy)
        a, b, d = m[..., 0], m[..., 1], m[..., 2]
        bxv = qx * a + qy * b + m[..., 3] + m[..., 4]
        byv = qx * b + qy * d + m[..., 5] + m[..., 6]
        det = a * d - b * b
        det = torch.where(det.abs() > 1e-9, det, torch.full_like(det, 1e-9))
        nx = (d * bxv - b * byv) / det
        ny = (a * byv - b * bxv) / det
        dx = torch.clamp(nx - qx, -1.0, 1.0)
        dy = torch.clamp(ny - qy, -1.0, 1.0)
        c = torch.stack([qx + dx, qy + dy], dim=-1)
    total = c - corners
    norm = torch.linalg.norm(total, dim=-1, keepdim=True)
    scale = torch.clamp(max_shift / torch.clamp(norm, min=1e-9), max=1.0)
    return corners + total * scale


def sample_bilinear_mm(images, sx, sy):
    """Bilinear-sample (B, H, W) images at per-image positions (B, K);
    positions are clipped to the image.  Returns (B, K) float32."""
    B, H, W = images.shape
    f = images.to(torch.float32).reshape(B, H * W)
    x0, y0, fx, fy = _floor_taps(sx, sy, H, W)

    def tap(dy, dx):
        return torch.gather(f, 1, (y0 + dy) * W + (x0 + dx))

    return (
        tap(0, 0) * (1 - fy) * (1 - fx)
        + tap(0, 1) * (1 - fy) * fx
        + tap(1, 0) * fy * (1 - fx)
        + tap(1, 1) * fy * fx
    )
