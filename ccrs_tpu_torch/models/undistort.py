"""Undistortion: new-camera-matrix estimation, remap tables, remapping.

Port of ``ccrs_tpu/models/undistort.py`` (the reference crate surface used
by both examples: ``estimate_new_camera_matrix_for_undistort`` +
``init_undistort_map`` + ``remap``, ``examples/convert_model.rs:27-30`` and
``examples/test_pnp.rs``).  Every output pixel unprojects through the ideal
pinhole and reprojects through the distorted model, giving the (xmap,
ymap) gather tables; ``remap`` is a bilinear gather written with explicit
indexing, in the JAX package's order of operations as XLA compiles it
(``F.grid_sample`` rounds and treats the edges differently).  The maps and
the remap run on ``device`` (default the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import GenericModel
from .projections import project_fn, unproject_fn

F64 = torch.float64


def estimate_new_camera_matrix_for_undistort(
    model: GenericModel, balance: float = 1.0, new_size=None, device="cuda"
):
    """Pinhole K for the undistorted view.

    balance = 0 keeps the tight (min) focal, 1 the wide (max) focal, like
    OpenCV's fisheye estimateNewCameraMatrixForUndistortRectify.
    Returns a 3x3 float64 numpy K.
    """
    w, h = model.width, model.height
    new_w, new_h = new_size if new_size is not None else (int(w), int(h))
    # OpenCV-fisheye style: undistort the 4 edge midpoints, interpolate the
    # focal between the all-visible (fmin) and no-loss (fmax) extremes
    pts = torch.tensor(
        [
            [(w - 1) / 2.0, 0.0],
            [w - 1.0, (h - 1) / 2.0],
            [(w - 1) / 2.0, h - 1.0],
            [0.0, (h - 1) / 2.0],
        ],
        dtype=F64, device=device,
    )
    rays, valid = unproject_fn(model.name)(
        torch.as_tensor(model.params, dtype=F64, device=device), pts
    )
    rays = rays.cpu().numpy()
    valid = valid.cpu().numpy() & (rays[:, 2] > 1e-6)
    if not valid.all():
        raise ValueError("edge midpoints do not unproject; cannot estimate K")
    m = rays[:, :2] / rays[:, 2:3]
    cn = m.mean(axis=0)
    aspect = 1.0
    minx, maxx = m[:, 0].min(), m[:, 0].max()
    miny, maxy = m[:, 1].min(), m[:, 1].max()
    f1 = new_w * 0.5 / max(cn[0] - minx, 1e-9)
    f2 = new_w * 0.5 / max(maxx - cn[0], 1e-9)
    f3 = new_h * 0.5 * aspect / max(cn[1] - miny, 1e-9)
    f4 = new_h * 0.5 * aspect / max(maxy - cn[1], 1e-9)
    fmin = min(f1, f2, f3, f4)
    fmax = max(f1, f2, f3, f4)
    balance = float(np.clip(balance, 0.0, 1.0))
    f = balance * fmin + (1.0 - balance) * fmax
    cx = -cn[0] * f + new_w * 0.5
    cy = -cn[1] * f + new_h * 0.5
    return np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])


def init_undistort_map(model: GenericModel, K, new_size, device="cuda"):
    """(xmap, ymap): float32 tensors of shape (new_h, new_w) on ``device``,
    built in float64; pixels whose ray does not project map to -1 (out of
    range, so ``remap`` writes 0 there)."""
    new_w, new_h = int(new_size[0]), int(new_size[1])
    K = torch.as_tensor(np.asarray(K, np.float64), dtype=F64, device=device)
    vv, uu = torch.meshgrid(
        torch.arange(new_h, dtype=F64, device=device),
        torch.arange(new_w, dtype=F64, device=device),
        indexing="ij",
    )
    x = (uu - K[0, 2]) / K[0, 0]
    y = (vv - K[1, 2]) / K[1, 1]
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)
    p2d, valid = project_fn(model.name)(
        torch.as_tensor(model.params, dtype=F64, device=device), rays
    )
    p2d = torch.where(valid[:, None], p2d, torch.full_like(p2d, -1.0))
    xmap = p2d[:, 0].reshape(new_h, new_w).to(torch.float32)
    ymap = p2d[:, 1].reshape(new_h, new_w).to(torch.float32)
    return xmap, ymap


def _fma(p, q, r):
    """p * q + r of float32 tensors, rounded once to float32, as a fused
    multiply-add rounds it.

    The product of two float32 values is exact in float64.  The sum is
    rounded to odd in float64: its rounding error (Knuth's TwoSum) picks,
    of the two doubles around the exact sum, the one with an odd last bit.
    Rounding that to float32 then gives the correctly rounded sum; a plain
    float64 sum would round twice, and differ at float32 ties."""
    s = p.double() * q.double()
    r = r.double()
    t = s + r
    b = t - s
    err = (s - (t - b)) + (r - b)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.nextafter(t, torch.where(err > 0, torch.inf, -torch.inf).to(t))
    return torch.where((err != 0) & even, toward, t).float()


def _remap(img, xmap, ymap):
    """Bilinear gather of a float32 (H, W) or (H, W, C) image at (xmap,
    ymap); out-of-range samples are 0.

    The JAX package writes the interpolation as a sum of four products;
    XLA's CPU compiler contracts the three additions into fused
    multiply-adds, ``fma(d fx, fy, fma(c (1-fx), fy, fma(a (1-fx), (1-fy),
    b fx (1-fy))))``, and this evaluates that expression, so both packages
    produce the same pixels (a plain float32 evaluation differs from it on
    about 1% of the output pixels by one gray level)."""
    H, W = img.shape[:2]
    x = torch.clamp(xmap, 0.0, W - 1.001)
    y = torch.clamp(ymap, 0.0, H - 1.001)
    oob = (xmap < 0) | (xmap > W - 1) | (ymap < 0) | (ymap > H - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    if img.ndim == 3:  # the same arithmetic per colour channel
        fx, fy, oob = fx[..., None], fy[..., None], oob[..., None]
    gx, gy = 1 - fx, 1 - fy
    v = _fma(img[y0, x0] * gx, gy, img[y0, x0 + 1] * fx * gy)
    v = _fma(img[y0 + 1, x0] * gx, fy, v)
    v = _fma(img[y0 + 1, x0 + 1] * fx, fy, v)
    return torch.where(oob, torch.zeros_like(v), v)


def remap(img, xmap, ymap):
    """Bilinear remap of a grayscale (H, W) or colour (H, W, C) image
    (numpy array or tensor) on the maps' device.  Returns a tensor there of
    the image's dtype, values clipped to 0..255 and truncated, as the JAX
    package's ``remap`` does.  A bool image follows it too: a gray (H, W)
    mask comes back as uint8 0/1 (the interpolated fraction truncated),
    a colour (H, W, C) mask as bool, true wherever the interpolated value
    is not 0."""
    img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img)
    out = _remap(img.to(device=xmap.device, dtype=torch.float32), xmap, ymap)
    out = torch.clamp(out, 0, 255)
    if img.dtype == torch.bool:
        return out.to(torch.uint8) if img.ndim == 2 else out != 0
    return out.to(img.dtype)
