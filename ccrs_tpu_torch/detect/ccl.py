"""Device quad extraction: connected components + corner recovery in torch.

Port of ``ccrs_tpu/detect/ccl.py``, the dense replacement for the host C++
quad extraction stage (``detect/quads.py``, quadproc): the thresholded
bitmaps stay on the device.  It is not wired into the detector (it is not
in the JAX package either); ``label_components`` and
``extract_quads_device`` give the JAX functions' results for the same
bitmap, also on shapes that have not converged after ``n_sweeps``.

Algorithm (per binary image, batched over frames):

1. **Labeling.**  Every dark pixel starts with its row-major index; labels
   relax to the component minimum by alternating row and column passes.
   One pass gives every dark pixel the minimum over its contiguous run of
   dark pixels along the axis.  The JAX package computes a pass as two
   segmented scans; here the runs are numbered once (a ``cumsum`` over run
   starts) and a pass is one running maximum over (run number, value)
   words and one gather from each run's last pixel.  (A ``scatter_reduce``
   into a per-run table gives the same result, but its atomic updates of
   one address per run serialise on the card: on an H100 it took nine
   times as long, ``python -m ccrs_tpu_torch.ccl_passes``.)
   Solid blobs converge in about 2 alternations, hollow shells in about 3;
   the loop runs a fixed ``n_sweeps``.
2. **Extreme points.**  For D directions (every 180/D degrees) and both
   signs, each dark pixel's (projection, perpendicular) coordinates are
   packed into one int32 (13 + 13 bits at half-pixel resolution) and the
   same passes, with max, propagate the component's extreme: every dark
   pixel then knows its component's 2D hull touchpoints in angular order.
3. **Roots and compaction.**  The pixel whose index equals its label is the
   component's root; the ``max_quads`` best roots per frame by bounding-box
   area (filtered by size, aspect and border) fill a fixed table.  Equal
   scores keep the lower pixel index first (a stable sort, as
   ``lax.top_k`` orders them).
4. **Corners.**  Per candidate the 4 touchpoints of maximum quadrilateral
   area over the C(2D, 4) index table; validity follows quadproc's checks
   (minimum area, area against bounding box, border).

Corners land within about 1 px of the C++ contour/line-fit corners.  The
packing centres coordinates on the image midpoint, so images with
sqrt(W^2 + H^2) < 4096 are supported (2048 px a side included).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from ..models.undistort import _fma

_COORD_BITS = 13
_COORD_BIAS = 1 << (_COORD_BITS - 1)  # 4096
_PACK = 1 << _COORD_BITS
#: frames per pass of ``extract_quads_device``: the packed extremes are
#: (frames, 2 n_dirs, H, W) int32, 1 GiB for 64 frames of 512 x 512, and a
#: pass over them holds two int64 tensors of that shape
FRAMES_PER_PASS = 64


class _Runs:
    """The contiguous dark runs of a (B, H, W) mask along rows (axis -1)
    and columns (axis -2), found once per mask: ``ids[axis]`` (B, 1, H, W)
    int64 numbers the runs in scan order (so they grow along the axis;
    white pixels have 0), shifted into the high half of the word, and
    ``end[axis]`` (B, 1, H, W) is the position along the axis of the last
    pixel of the run a dark pixel lies in."""

    def __init__(self, black):
        self.black = black[:, None]
        self.ids, self.end = {}, {}
        for axis in (-1, -2):
            b = black if axis == -1 else black.transpose(-1, -2)
            L = b.shape[-1]
            start = b.clone()
            start[..., 1:] &= ~b[..., :-1]  # dark with a white (or no) predecessor
            ids = torch.cumsum(start.reshape(-1), 0).reshape(b.shape)
            ids = torch.where(b, ids, torch.zeros_like(ids)) << 32
            last = b.clone()
            last[..., :-1] &= ~b[..., 1:]  # dark with a white (or no) successor
            pos = torch.arange(L, device=b.device).expand(b.shape)
            end = torch.where(last, pos, torch.full_like(pos, L - 1))
            end = end.flip(-1).cummin(-1).values.flip(-1)  # nearest run end at or after
            if axis == -2:
                ids, end = ids.transpose(-1, -2), end.transpose(-1, -2)
            self.ids[axis], self.end[axis] = ids[:, None], end[:, None]

    def reduce(self, vals, axis: int, combine_max: bool):
        """(B, C, H, W) int32: every dark pixel gets the max (min) of
        ``vals`` over its run along ``axis``; white pixels keep theirs.

        With the run number in the high half of an int64 and the value in
        the low half, a running maximum along the axis restarts at every
        run, so its value at the run's last pixel is the run's maximum."""
        v = vals if combine_max else -vals
        key = self.ids[axis] + (v.to(torch.int64) + (1 << 31))
        running = torch.cummax(key, dim=axis).values
        out = running.gather(axis, self.end[axis].expand_as(running))
        out = ((out & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
        return torch.where(self.black, out if combine_max else -out, vals)

    def sweep(self, vals, combine_max: bool, n_sweeps: int):
        """Alternate row and column passes, ``n_sweeps`` times."""
        for _ in range(n_sweeps):
            vals = self.reduce(vals, -1, combine_max)
            vals = self.reduce(vals, -2, combine_max)
        return vals


def _pixel_index(B: int, H: int, W: int, device):
    idx = torch.arange(H * W, dtype=torch.int32, device=device)
    return idx.reshape(1, H, W).expand(B, H, W)


def _labels(black, runs: _Runs, n_sweeps: int):
    B, H, W = black.shape
    idx = _pixel_index(B, H, W, black.device)
    labels = torch.where(black, idx, torch.full_like(idx, H * W))
    return runs.sweep(labels[:, None], False, n_sweeps)[:, 0], idx


def label_components(binary, n_sweeps: int = 6, device="cuda"):
    """4-connected labeling of dark pixels.

    Args:
      binary: (B, H, W) uint8/bool array or tensor, nonzero = white.

    Returns int32 (B, H, W) on ``device``: for dark pixels the component's
    minimum row-major pixel index (once converged), for white pixels H*W.
    """
    black = torch.as_tensor(binary).to(device) == 0
    labels, _ = _labels(black, _Runs(black), n_sweeps)
    return torch.where(black, labels, torch.full_like(labels, black.shape[1] * black.shape[2]))


def _quad_index_table(n_pts: int):
    """C(n, 4) index table (i<j<k<l) for the maximum-area corner choice."""
    return np.asarray(list(combinations(range(n_pts), 4)), np.int64)


def _mul_add(a, ca: float, b, cb: float):
    """float32 ``a * ca + b * cb`` with the first product fused into the
    sum (one rounding) and the second rounded on its own:
    ``fma(a, ca, round(b * cb))``.

    The JAX package's compiled code contracts these sums into fused
    multiply-adds on the CPU.  The projections are packed at half-pixel
    steps, so a plain float32 evaluation, which rounds both products,
    lands on the other side of a rounding tie for a few pixels in a
    thousand and would move their touchpoint by half a pixel.  Which
    product is fused was measured per expression against the compiled
    reference; the callers pass that one first."""
    ca = torch.tensor(ca, dtype=torch.float32, device=a.device)
    return _fma(a, ca, b * cb)


def _extract(black, max_quads, n_dirs, n_sweeps, min_side, min_area):
    B, H, W = black.shape
    n_pix = H * W
    dev = black.device
    f32 = torch.float32
    runs = _Runs(black)

    # ---- 1. labels -------------------------------------------------------
    labels, idx = _labels(black, runs, n_sweeps)
    is_root = black & (labels == idx)

    # ---- 2. extreme points in 2*n_dirs directions ------------------------
    W2, H2 = W / 2.0, H / 2.0  # centre to halve the packed range
    ys = torch.div(idx, W, rounding_mode="floor").to(f32) - H2
    xs = torch.remainder(idx, W).to(f32) - W2
    angles = np.pi * np.arange(n_dirs) / n_dirs
    packed = []
    for a in angles:
        c, s = float(np.cos(a)), float(np.sin(a))
        # for a direction with a negative cosine the compiled reference
        # fuses the other product
        if c >= 0:
            proj, perp = _mul_add(xs, c, ys, s), _mul_add(ys, c, -xs, s)
        else:
            proj, perp = _mul_add(ys, s, xs, c), _mul_add(-xs, s, ys, c)
        proj = torch.round(2.0 * proj).to(torch.int32)
        perp = torch.round(2.0 * perp).to(torch.int32)
        perp_b = perp + _COORD_BIAS  # >= 0
        for sign in (1, -1):
            packed.append((sign * proj + _COORD_BIAS) * _PACK + perp_b)
    packed = torch.stack(packed, dim=1)  # (B, 2D, H, W), angular pairs (+,-)
    ext = runs.sweep(packed, True, n_sweeps)
    del packed

    # unpack to (x, y) per direction channel
    perp_u = torch.remainder(ext, _PACK) - _COORD_BIAS
    proj_u = torch.div(ext, _PACK, rounding_mode="floor") - _COORD_BIAS
    del ext
    ch = 0
    ex_list, ey_list, pmax = [], [], {}
    for d, a in enumerate(angles):
        c, s = float(np.cos(a)), float(np.sin(a))
        for sign in (1, -1):
            pr = (sign * proj_u[:, ch]).to(f32) * 0.5
            pe = perp_u[:, ch].to(f32) * 0.5
            ex_list.append(_mul_add(pr, c, pe, -s) + W2)  # un-centre
            ey = _mul_add(pe, c, pr, s) if c >= 0 else _mul_add(pr, s, pe, c)
            ey_list.append(ey + H2)
            pmax[(d, sign)] = pr
            ch += 1
    del perp_u, proj_u

    # ---- 3. roots + per-frame compaction ---------------------------------
    # bbox from the axis-aligned channels: dir 0 = x, dir D/2 = y
    # (pmax[(d, -1)] holds the min projection: the -1 channel propagates
    # max(-proj) and pr multiplies the sign back)
    xmax, xmin = pmax[(0, 1)] + W2, pmax[(0, -1)] + W2  # back to image coords
    d_y = n_dirs // 2
    ymax, ymin = pmax[(d_y, 1)] + H2, pmax[(d_y, -1)] + H2
    bw = xmax - xmin + 1.0
    bh = ymax - ymin + 1.0
    aspect = torch.maximum(bw / bh.clamp(min=1e-6), bh / bw.clamp(min=1e-6))
    ok_geom = (
        (bw >= min_side)
        & (bh >= min_side)
        & (aspect <= 12.0)
        & (xmin >= 1)
        & (ymin >= 1)
        & (xmax <= W - 2)
        & (ymax <= H - 2)
    )
    bbox = (bw * bh).reshape(B, n_pix)
    score = torch.where((is_root & ok_geom).reshape(B, n_pix), bbox, torch.zeros_like(bbox))
    # equal scores (most are 0) keep the lower pixel index first
    top_scores, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :max_quads], top_idx[:, :max_quads]
    slot_valid = top_scores > 0.0

    # gather each candidate's 2D touchpoints, reordered to angular sequence
    # (+d0, +d1, ..., +d(D-1), -d0, -d1, ...)
    order = list(range(0, 2 * n_dirs, 2)) + list(range(1, 2 * n_dirs, 2))
    sel = top_idx[:, None, :].expand(B, 2 * n_dirs, top_idx.shape[1])
    cx = torch.stack([ex_list[i].reshape(B, n_pix) for i in order], dim=1).gather(2, sel)
    cy = torch.stack([ey_list[i].reshape(B, n_pix) for i in order], dim=1).gather(2, sel)
    pts = torch.stack([cx, cy], dim=-1).permute(0, 2, 1, 3)  # (B, K, 2D, 2)

    # ---- 4. max-area quadrilateral over the hull touchpoints -------------
    combos = torch.as_tensor(_quad_index_table(2 * n_dirs), device=dev)  # (M, 4)
    p_sel = pts[:, :, combos, :]  # (B, K, M, 4, 2)
    x, y = p_sel[..., 0], p_sel[..., 1]
    # shoelace terms and their sum in the compiled reference's rounding
    # (each term one fused multiply-add, the four added in order): among
    # subsets of nearly equal area the argmax below follows the last bit
    term = _fma(x, torch.roll(y, -1, dims=-1), -(torch.roll(x, -1, dims=-1) * y))
    area2 = ((term[..., 0] + term[..., 1]) + term[..., 2]) + term[..., 3]
    best = torch.argmax(area2.abs(), dim=-1)  # (B, K): the first of equal areas
    quad = p_sel.gather(2, best[:, :, None, None, None].expand(B, -1, 1, 4, 2))[:, :, 0]
    best_area2 = area2.gather(2, best[:, :, None])[..., 0]

    # clockwise in image coordinates (positive shoelace with y down)
    quad = torch.where((best_area2 < 0)[..., None, None], quad.flip(2), quad)

    bbox_area = bbox.gather(1, top_idx)
    qa = 0.5 * best_area2.abs()
    valid = slot_valid & (qa >= 0.3 * bbox_area) & (qa >= min_area)
    return quad, valid


def extract_quads_device(
    binary,
    max_quads: int = 64,
    n_dirs: int = 8,
    n_sweeps: int = 6,
    min_side: int = 4,
    min_area: int = 25,
    device="cuda",
):
    """Candidate dark quads from a batch of binary images, on ``device``.

    Args:
      binary: (B, H, W) uint8 {0,1} array or tensor, 1 = white (as
        ``adaptive_threshold`` emits).
      max_quads: per-frame candidate capacity.

    Returns:
      quads: (B, max_quads, 4, 2) float32 corners, clockwise in image
        coordinates (y down), arbitrary starting corner.
      valid: (B, max_quads) bool.
    """
    binary = torch.as_tensor(binary).to(device)
    B, H, W = binary.shape
    # packing budget: coordinates are centred on the image midpoint before
    # projecting, so proj/perp at half-pixel resolution are bounded by
    # sqrt(W^2 + H^2), which must fit the signed 13-bit field; the +0.5
    # covers the rounding: a projection in (4095.5, 4096) would round to
    # 4096 and carry into the neighbouring packed field
    if not (W * W + H * H) ** 0.5 + 0.5 < _COORD_BIAS:
        raise ValueError(f"image {W}x{H} too large for int32 extreme packing")
    black = binary == 0
    quads, valid = [], []
    for lo in range(0, B, FRAMES_PER_PASS):
        q, v = _extract(
            black[lo : lo + FRAMES_PER_PASS], max_quads, n_dirs, n_sweeps, min_side, min_area
        )
        quads.append(q)
        valid.append(v)
    return torch.cat(quads), torch.cat(valid)
