"""Board frames rendered on the device, the benchmark's own renderer.

Every output pixel is inverse-mapped through the camera onto the board
plane (3 x 3 supersampled), blurred by a Gaussian PSF of ``blur_sigma``
pixels, given Gaussian sensor noise of ``noise`` gray levels drawn from a
``torch.Generator`` on the device, and rounded to uint8.  The corners of
the rendered tags lie exactly at ``camera.project(params, T p3d)``: that
is the ground truth of detection.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from . import camera
from .board import Board, Family

#: frames per supersampling pass (bounds its memory: about 20 x 64 H W float32)
FRAMES_PER_PASS = 64


def board_texture(board: Board, family: Family):
    """The printed board as a texture: (tex (Hc, Wc) float32 of 1 white /
    0 black, (ox, oy) the board coordinates of texel (0, 0), texels per
    metre).  Kalibr-style black squares fill the gaps between tag corners."""
    T = family.total_size
    s = board.tag_size
    pitch = s * (1.0 + board.spacing)
    frac = Fraction(board.spacing * T).limit_denominator(64)
    sub = min(frac.denominator, 20)  # tag pitch and gap squares on the texel grid
    cell = s / (T * sub)
    Tf = T * sub
    margin = int(np.ceil((pitch - s) / cell)) + Tf
    Wc = int(np.ceil((board.cols - 1) * pitch / cell)) + Tf + 2 * margin
    Hc = int(np.ceil((board.rows - 1) * pitch / cell)) + Tf + 2 * margin
    tex = np.ones((Hc, Wc), np.float32)
    ox, oy = -margin * cell, margin * cell
    for r in range(board.rows):
        for c in range(board.cols):
            tag = board.first_id + r * board.cols + c
            bits = family.codes[tag].reshape(family.size, family.size)
            ci0 = int(round((c * pitch - ox) / cell))
            ri0 = int(round((oy + r * pitch) / cell))
            cells = np.zeros((T, T), np.float32)
            # the print faces the board's -z side, so its bits are x-mirrored
            cells[family.border:T - family.border, family.border:T - family.border] = \
                bits[:, ::-1]
            tex[ri0:ri0 + T * sub, ci0:ci0 + T * sub] = np.kron(cells, np.ones((sub, sub)))
    gap = int(round(board.spacing * T * sub))
    if gap > 0:
        for r in range(board.rows + 1):
            for c in range(board.cols + 1):
                ci0 = int(round((c * pitch - board.spacing * s - ox) / cell))
                ri0 = int(round((oy - (-r * pitch + board.spacing * s)) / cell))
                tex[ri0:ri0 + gap, ci0:ci0 + gap] = 0.0
    return tex, (ox, oy), 1.0 / cell


def _supersampled(params, poses, tex, ox, oy, scale, width, height, ss=3,
                  white=220.0, black=35.0, bg=128.0):
    dt, dev = params.dtype, params.device
    off = torch.as_tensor((np.arange(ss) + 0.5) / ss - 0.5).to(dt).tolist()
    vv, uu = torch.meshgrid(torch.arange(height, dtype=dt, device=dev),
                            torch.arange(width, dtype=dt, device=dev), indexing="ij")
    Rinv = camera.rotation(poses[:, :3]).mT
    t_board = -(Rinv @ poses[:, 3:, None])[..., 0]
    Hc, Wc = tex.shape
    acc = torch.zeros((poses.shape[0], width * height), dtype=dt, device=dev)
    for du in off:
        for dv in off:
            pix = torch.stack([uu + du, vv + dv], -1).reshape(-1, 2)
            ray, valid = camera.unproject(params, pix)
            d = ray @ Rinv.mT
            dz = d[..., 2]
            k = -t_board[:, 2:3] / torch.where(dz.abs() > 1e-12, dz, torch.full_like(dz, 1e-12))
            X = k[..., None] * d + t_board[:, None, :]
            tx = (X[..., 0] - ox) * scale
            ty = (oy - X[..., 1]) * scale
            inside = (tx >= 0) & (tx < Wc) & (ty >= 0) & (ty < Hc) & (k > 0) & valid
            v = tex[torch.clamp(ty.to(torch.int64), 0, Hc - 1),
                    torch.clamp(tx.to(torch.int64), 0, Wc - 1)]
            acc = acc + torch.where(inside, black + (white - black) * v, torch.full_like(v, bg))
    return (acc / (ss * ss)).reshape(-1, height, width)


def _mirror_index(n: int, r: int, device):
    i = np.arange(-r, n + r)
    i = np.where(i < 0, -i - 1, i)
    i = np.where(i >= n, 2 * n - 1 - i, i)
    return torch.as_tensor(i, device=device)


def render(params, width: int, height: int, board: Board, family: Family, poses,
           generator: torch.Generator, noise: float, blur_sigma: float = 0.7):
    """(F, 6) poses -> (F, height, width) uint8 frames on the generator's device."""
    dev = generator.device
    f32 = torch.float32
    tex, (ox, oy), scale = board_texture(board, family)
    radius = max(1, int(4.0 * blur_sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / blur_sigma) ** 2)
    kern = (k / k.sum()).astype(np.float32)
    p = torch.as_tensor(np.asarray(params), dtype=f32, device=dev)
    tex_t = torch.as_tensor(tex, dtype=f32, device=dev)
    poses_t = torch.as_tensor(np.asarray(poses), dtype=f32, device=dev)
    rows = _mirror_index(height, radius, dev)
    cols = _mirror_index(width, radius, dev)
    out = torch.empty((poses_t.shape[0], height, width), dtype=torch.uint8, device=dev)
    for lo in range(0, poses_t.shape[0], FRAMES_PER_PASS):
        img = _supersampled(p, poses_t[lo:lo + FRAMES_PER_PASS], tex_t, float(np.float32(ox)),
                            float(np.float32(oy)), float(np.float32(scale)), width, height)
        q = img.index_select(1, rows)
        img = sum(float(kern[i]) * q[:, i:i + height, :] for i in range(len(kern)))
        q = img.index_select(2, cols)
        img = sum(float(kern[i]) * q[:, :, i:i + width] for i in range(len(kern)))
        if noise > 0:
            img = img + torch.randn(img.shape, generator=generator, device=dev, dtype=f32) * noise
        out[lo:lo + img.shape[0]] = torch.round(torch.clamp(img, 0, 255)).to(torch.uint8)
    return out
