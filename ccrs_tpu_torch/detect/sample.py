"""Image sampling for corner refinement and decoding, in two formulations.

Port of ``ccrs_tpu/detect/sample.py``.  Every sampling pattern the detector
needs is a linear map of the image, so each function has two branches that
compute the same quantity:

- the matmul branch: separable window sums as banded matrix products
  (``_band``: image @ K^T, K @ image) and bilinear sampling as tent
  ("hat") weight rows and columns (``_hat``): out = sum over the row
  weights @ image, reduced against the column weights.  It trades a few
  large products for the many small launches of the other branch;
- the gather branch: 7-tap loops (``_tap_corr``) and 4-tap bilinear gathers.

The branch follows the input tensor's device, as the JAX package's follows
its backend, unless a caller passes ``use_matmul=``: the gather branch on
the CPU (where the band matrices cost O(H) more work than the taps they
encode, as in the JAX package) and on the card, the matmul branch on any
other device.  The card is the port's one departure from the JAX rule, and
a measured one (``chip_smoke.py``'s ``sampling`` phase; ROADMAP.md has the
numbers): on an H100 the matmul branch was never faster than the
gather branch by more than the spread between runs, was slower by more
than it on 1024x1024 and 752x480 frames, where it makes the card the
bottleneck, and its products can round a frame's corners differently with
the frames batched beside it (cuBLAS picks its algorithm by shape), so
sharded detection would no longer equal unsharded bit for bit.  The
gather branch computes each frame alone.  ``matmul_branch``
forces one branch for a block of code, so that a parity check can run both
sides through the same formulation; only tests and ``chip_smoke.py`` use it.

Precision differs from the JAX package on purpose: its matmul branch runs
bf16 operands off the CPU; here both branches are float32 on every device
(``_mm_dtype``), and the package turns TF32 off, so the products run in
full float32 (the geometry's precision rule, ``ccrs_tpu_torch/__init__.py``).

- ``unsharp_mm``: 7-tap separable Gaussian unsharp mask (replicate border);
- ``build_klt_maps``: the 7 structure-tensor window sums of the subpixel
  corner refinement (zero border);
- ``refine_corners_mm``: 12 Newton steps per corner against the maps;
- ``sample_bilinear_mm``: bilinear samples at per-image positions.

Positions are clipped to [0, size - 1.001] before either branch samples:
the +1 gather taps then stay in range (torch raises, and CUDA asserts, on
an out-of-range index, where XLA clamps silently), and a hat row has its
two weights on real pixels.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

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

#: device types that take the gather branch by default: the CPU, as in the
#: JAX package, and the card (measured: see the module docstring)
_GATHER_DEVICES = frozenset({"cpu", "cuda"})

#: the branch ``matmul_branch`` forces, or None: each call follows its input
_forced = None


@contextlib.contextmanager
def matmul_branch(on: bool):
    """Run every call of this module inside the block through the matmul
    branch (``on=True``) or the gather branch, whatever the device, unless
    the call passes ``use_matmul=``.  Process-wide; restored on exit."""
    global _forced
    before = _forced
    _forced = bool(on)
    try:
        yield
    finally:
        _forced = before


def _mm_dtype():
    """float32 on every device (the JAX package takes bf16 off the CPU)."""
    return torch.float32


def _use_mm(force, x) -> bool:
    """``force`` when given, else the scoped switch, else the matmul branch
    unless ``x`` lies on a device of ``_GATHER_DEVICES``."""
    if force is not None:
        return bool(force)
    if _forced is not None:
        return _forced
    return x.device.type not in _GATHER_DEVICES


@lru_cache(maxsize=None)
def _band_np(size: int, which: str, edge: bool) -> np.ndarray:
    """Banded correlation matrix C with C[u, h] = taps[h - u + WIN].

    ``edge=True`` folds out-of-range taps onto the border element
    (replicate padding); ``edge=False`` truncates (zero padding, matching
    the refine maps' zero boundary).
    """
    taps = {"g": _G_TAPS, "go": _GO_TAPS, "blur": _BLUR_TAPS}[which]
    R = (len(taps) - 1) // 2
    out = np.zeros((size, size), np.float32)
    for u in range(size):
        for t in range(-R, R + 1):
            h = u + t
            if edge:
                h = min(max(h, 0), size - 1)
            elif not (0 <= h < size):
                continue
            out[u, h] += taps[t + R]
    return out


@lru_cache(maxsize=None)
def _band(size: int, which: str, edge: bool, device: torch.device) -> torch.Tensor:
    """``_band_np`` on ``device``, made once per device (as
    ``decode._dense_constants``): a chunk then uploads nothing from
    pageable memory, which would wait for the whole stream."""
    return torch.as_tensor(_band_np(size, which, edge), dtype=_mm_dtype(), device=device)


@lru_cache(maxsize=None)
def _grid(size: int, device: torch.device) -> torch.Tensor:
    """Pixel centres 0 .. size-1 (float32) on ``device``, made once."""
    return torch.arange(size, dtype=torch.float32, device=device)


def _convy(x, K):
    """Correlate along H (dim -2): out[b, u, w] = sum_h K[u, h] x[b, h, w]."""
    return torch.matmul(K, x.to(K.dtype))


def _convx(x, K):
    """Correlate along W (dim -1): out[b, h, v] = sum_w K[v, w] x[b, h, w]."""
    return torch.matmul(x.to(K.dtype), K.T)


def _hat(pos, grid):
    """Bilinear tent weights: (..., K) positions -> (..., K, size) with
    max(0, 1 - |pos - grid|); a position clipped to [0, size - 1.001] has
    its two weights on pixels floor(pos) and floor(pos) + 1."""
    return torch.clamp(1.0 - (pos[..., None] - grid).abs(), min=0.0)


def _tap_corr(x, taps: np.ndarray, dim: int, edge: bool):
    """out[u] = sum_t taps[t+R] x[u + t] along ``dim``, with replicate
    (edge=True) or zero (edge=False) boundary: the banded product's
    O(T*H*W) form."""
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
        out = term if out is None else out.add_(term)  # out is this loop's own
    return out


def unsharp_mm(images, amount: float = 1.2, use_matmul=None):
    """Unsharp mask of a (B, H, W) batch (decode bit sampling only: it keeps
    the ~3 px data cells of far tags apart): two banded products, or the
    7-tap loop.  Returns float32."""
    B, H, W = images.shape
    images = images.to(torch.float32)
    if _use_mm(use_matmul, images):
        dev = images.device
        blur = _convx(_convy(images, _band(H, "blur", True, dev)), _band(W, "blur", True, dev))
    else:
        blur = _tap_corr(_tap_corr(images, _BLUR_TAPS, 1, True), _BLUR_TAPS, 2, True)
    return images + amount * (images - blur)


def build_klt_maps(images, use_matmul=None):
    """The 7 structure-tensor maps on the full image: A=w(*)gx^2,
    B=w(*)gxgy, D=w(*)gy^2 and the four first-moment maps
    (w*ox*gx^2, w*oy*gxgy, w*ox*gxgy, w*oy*gy^2).

    Returns (B, 7, H, W) float32; window sums use a zero border.  The
    matmul branch's 12 banded products are stored as (B, H, 7, W) in
    memory and returned as a permuted view, the layout its refine product
    reads as (B, H, 7*W) without a copy.  Each map is written into the
    result as it is made and every intermediate goes after its last use,
    which keeps the peak memory down: a captured graph's memory pool holds
    that peak (``graphs.py``)."""
    f = images.to(torch.float32)
    B, H, W = f.shape
    gx = torch.zeros_like(f)
    gy = torch.zeros_like(f)
    gx[:, :, 1:-1] = (f[:, :, 2:] - f[:, :, :-2]) * 0.5
    gy[:, 1:-1, :] = (f[:, 2:, :] - f[:, :-2, :]) * 0.5
    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy
    del gx, gy
    mm = _use_mm(use_matmul, f)
    if mm:
        dev = f.device
        g_h, go_h = _band(H, "g", False, dev), _band(H, "go", False, dev)
        g_w, go_w = _band(W, "g", False, dev), _band(W, "go", False, dev)
        cy, cx = _convy, _convx
    else:
        g_h, go_h, g_w, go_w = _G_TAPS, _GO_TAPS, _G_TAPS, _GO_TAPS

        def cy(x, t):
            return _tap_corr(x, t, 1, False)

        def cx(x, t):
            return _tap_corr(x, t, 2, False)

    # y (row) pass once per (source, ky) pair, then x (col) passes
    gxx_g = cy(gxx, g_h)
    del gxx
    gxy_g = cy(gxy, g_h)
    gxy_go = cy(gxy, go_h)
    del gxy
    gyy_g = cy(gyy, g_h)
    gyy_go = cy(gyy, go_h)
    del gyy
    if mm:
        maps = f.new_empty((B, H, 7, W)).permute(0, 2, 1, 3)
    else:
        maps = f.new_empty((B, 7, H, W))
    maps[:, 0] = cx(gxx_g, g_w)    # A
    maps[:, 3] = cx(gxx_g, go_w)   # sum w*ox*gx^2
    del gxx_g
    maps[:, 1] = cx(gxy_g, g_w)    # B
    maps[:, 5] = cx(gxy_g, go_w)   # sum w*ox*gx*gy
    del gxy_g
    maps[:, 4] = cx(gxy_go, g_w)   # sum w*oy*gx*gy
    del gxy_go
    maps[:, 2] = cx(gyy_g, g_w)    # D
    del gyy_g
    maps[:, 6] = cx(gyy_go, g_w)   # sum w*oy*gy^2
    return maps


def _floor_taps(x, y, H: int, W: int):
    """Bilinear-tap indices/fractions, positions clipped to the image so
    the +1 taps stay in range (the hat rows' clip)."""
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0.to(torch.int64), y0.to(torch.int64), x - x0, y - y0


def _sample_maps_gather(flat, qx, qy, H: int, W: int):
    """Bilinear-gather the maps, flattened to (B, C, H*W), at (B, M)
    points -> (B, M, C)."""
    B, C, _ = flat.shape
    M = qx.shape[1]
    x0, y0, fx, fy = _floor_taps(qx, qy, H, W)

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
                      max_shift: float = MAX_SHIFT, use_matmul=None):
    """Subpixel-refine (B, M, 2) float32 (x, y) corners against the
    (B, 7, H, W) KLT maps: Newton steps with a 1 px/iteration clamp, then a
    total-shift clamp.  Each step samples the 7 maps at the current
    points: one (B, M, H) @ (B, H, 7W) product of hat rows, reduced
    against the hat columns, or four gathers.  Returns (B, M, 2)."""
    B, C, H, W = maps.shape
    if _use_mm(use_matmul, maps):
        # free for build_klt_maps' layout; a copy (once per call) otherwise
        rows = maps.permute(0, 2, 1, 3).reshape(B, H, C * W)
        grid_h, grid_w = _grid(H, maps.device), _grid(W, maps.device)

        def sample(qx, qy):
            Wy = _hat(torch.clamp(qy, 0.0, H - 1.001), grid_h)    # (B, M, H)
            Wx = _hat(torch.clamp(qx, 0.0, W - 1.001), grid_w)    # (B, M, W)
            A = torch.bmm(Wy, rows).view(B, -1, C, W)             # (B, M, C, W)
            return torch.matmul(A, Wx[..., None])[..., 0]         # (B, M, C)
    else:
        flat = maps.reshape(B, C, H * W)

        def sample(qx, qy):
            return _sample_maps_gather(flat, qx, qy, H, W)

    c = corners
    for _ in range(iters):
        qx, qy = c[..., 0], c[..., 1]
        m = sample(qx, qy)
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


def sample_bilinear_mm(images, sx, sy, max_rows_mb: int = 192, use_matmul=None):
    """Bilinear-sample (B, H, W) images at per-image positions (B, K);
    positions are clipped to the image.  Returns (B, K) float32.

    The matmul branch computes hat(sy) @ image and reduces it against
    hat(sx), in pieces of K small enough that a piece's (B, Kc, H) row
    weights stay under ``max_rows_mb`` MB (the JAX package's rule, with
    float32 operands)."""
    B, H, W = images.shape
    f = images.to(torch.float32)
    if not _use_mm(use_matmul, f):
        flat = f.reshape(B, H * W)
        x0, y0, fx, fy = _floor_taps(sx, sy, H, W)

        def tap(dy, dx):
            return torch.gather(flat, 1, (y0 + dy) * W + (x0 + dx))

        return (
            tap(0, 0) * (1 - fy) * (1 - fx)
            + tap(0, 1) * (1 - fy) * fx
            + tap(1, 0) * fy * (1 - fx)
            + tap(1, 1) * fy * fx
        )
    K = sx.shape[1]
    bpe = torch.finfo(_mm_dtype()).bits // 8
    kc = max(256, int(max_rows_mb * 1e6 / (B * H * bpe)))
    grid_h, grid_w = _grid(H, f.device), _grid(W, f.device)
    outs = []
    for s in range(0, K, kc):
        Wy = _hat(torch.clamp(sy[:, s : s + kc], 0.0, H - 1.001), grid_h)   # (B, Kc, H)
        Wx = _hat(torch.clamp(sx[:, s : s + kc], 0.0, W - 1.001), grid_w)   # (B, Kc, W)
        outs.append((torch.bmm(Wy, f) * Wx).sum(dim=2))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
