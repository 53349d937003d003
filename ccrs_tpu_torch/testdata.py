"""Synthetic AprilGrid frame renderer.

Port of the renderer of ``ccrs_tpu/testdata.py`` that the benchmark
composition uses: every output pixel is inverse-mapped through the camera
model onto the board plane (3x3 supersampled), blurred by a Gaussian PSF,
given sensor noise and quantized to uint8 — on the device the frames are
then detected on.  Poses are generated with numpy on the host, so a seed
gives the same trajectory in both packages.

Ground truth: the rendered corner positions are exactly
``project(params, T_cam_board . p3d_corner)`` (``gt_corners``).
"""

from __future__ import annotations

import numpy as np
import torch

from .board import Board
from .detect.families import TagFamily
from .models import GenericModel
from .models.projections import unproject_fn
from .solve import se3

F64 = torch.float64
#: frames rendered per supersampling pass (bounds its memory: ~16 x 9 x H x W
#: float32 intermediates)
FRAMES_PER_PASS = 16


def board_pattern_image(
    board: Board, family: TagFamily, corner_squares: bool = True
):
    """Rasterize the board layout into a cell-resolution lookup table.

    Returns (tex, origin, scale): tex is a (Hc, Wc) float32 array of cell
    intensities (1 white, 0 black) covering the board's bounding box with
    ``total_size`` cells per tag edge; world (x, y) maps to texel
    ``(x - ox) * scale``, ``(oy - y) * scale``.
    """
    from fractions import Fraction

    cfg = board.config
    T = family.total_size
    s = cfg.tag_size_meter
    pitch = s * (1.0 + cfg.tag_spacing)
    # sub-cell rasterization factor: the tag pitch and the corner squares
    # must both land on the texel grid exactly, or tags render up to half
    # a cell off their ground-truth positions
    frac = Fraction(cfg.tag_spacing * T).limit_denominator(64)
    sub = min(frac.denominator, 20)
    cell = s / (T * sub)  # fine texel size (meters)
    Tf = T * sub  # tag side in texels
    margin_cells = int(np.ceil((pitch - s) / cell)) + Tf
    Wc = int(np.ceil((cfg.tag_cols - 1) * pitch / cell)) + Tf + 2 * margin_cells
    Hc = int(np.ceil((cfg.tag_rows - 1) * pitch / cell)) + Tf + 2 * margin_cells
    tex = np.ones((Hc, Wc), np.float32)
    ox = -margin_cells * cell
    oy = margin_cells * cell  # world y of texture row 0 (y decreases with row)
    for r in range(cfg.tag_rows):
        for c in range(cfg.tag_cols):
            tag_id = cfg.first_id + r * cfg.tag_cols + c
            if tag_id >= family.n_codes:
                continue
            bits = family.codes[tag_id].reshape(family.size, family.size)
            x0 = c * pitch
            y0 = -r * pitch
            ci0 = int(round((ox * -1 + x0) / cell))
            ri0 = int(round((oy - y0) / cell))
            for i in range(T):
                for j in range(T):
                    inner = (
                        family.border <= i < T - family.border
                        and family.border <= j < T - family.border
                    )
                    if inner:
                        # the print faces the board's -z side (front view
                        # R = rot_z(pi)), so its layout in board
                        # coordinates is x-mirrored
                        jj = (family.size - 1) - (j - family.border)
                        v = float(bits[i - family.border, jj])
                    else:
                        v = 0.0
                    tex[
                        ri0 + i * sub : ri0 + (i + 1) * sub,
                        ci0 + j * sub : ci0 + (j + 1) * sub,
                    ] = v
    # Kalibr-style corner squares in every inter-tag gap intersection (they
    # diagonally touch tag corners, as on real EuRoC/TUM-VI boards)
    gap_cells = int(round(cfg.tag_spacing * T * sub))
    if corner_squares and gap_cells > 0:
        for r in range(cfg.tag_rows + 1):
            for c in range(cfg.tag_cols + 1):
                x_left = c * pitch - cfg.tag_spacing * s
                y_top = -r * pitch + cfg.tag_spacing * s
                ci0 = int(round((x_left - ox) / cell))
                ri0 = int(round((oy - y_top) / cell))
                tex[ri0 : ri0 + gap_cells, ci0 : ci0 + gap_cells] = 0.0
    return tex, (ox, oy), 1.0 / cell


def _render(
    proj_name, params, poses, tex, ox, oy, scale, width: int, height: int,
    ss: int = 3, white: float = 220.0, black: float = 35.0, bg: float = 128.0,
):
    """Supersampled board images (F, H, W) for poses (F, 6), in the dtype
    of ``params``; every tensor on one device."""
    dt, dev = params.dtype, params.device
    unproj = unproject_fn(proj_name)
    off = ((np.arange(ss) + 0.5) / ss - 0.5).astype(np.float32)
    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=dt, device=dev),
        torch.arange(width, dtype=dt, device=dev),
        indexing="ij",
    )
    Rinv = se3.exp_so3(poses[:, :3]).mT  # (F, 3, 3)
    t_board = -(Rinv @ poses[:, 3:, None])[..., 0]  # (F, 3)
    Hc, Wc = tex.shape

    def sample(du, dv):
        pix = torch.stack([uu + du, vv + dv], dim=-1).reshape(-1, 2)
        ray, valid = unproj(params, pix)
        # board frame: X = s * Rinv d + t_board with X_z = 0
        d = ray @ Rinv.mT  # (F, HW, 3)
        dz = d[..., 2]
        denom = torch.where(dz.abs() > 1e-12, dz, torch.full_like(dz, 1e-12))
        sscale = -t_board[:, 2:3] / denom
        X = sscale[..., None] * d + t_board[:, None, :]
        infront = (sscale > 0) & valid
        tx = (X[..., 0] - ox) * scale
        ty = (oy - X[..., 1]) * scale
        inside = (tx >= 0) & (tx < Wc) & (ty >= 0) & (ty < Hc) & infront
        txi = torch.clamp(tx.to(torch.int64), 0, Wc - 1)
        tyi = torch.clamp(ty.to(torch.int64), 0, Hc - 1)
        cellv = tex[tyi, txi]
        return torch.where(
            inside, black + (white - black) * cellv, torch.full_like(cellv, bg)
        )

    acc = torch.zeros((poses.shape[0], width * height), dtype=dt, device=dev)
    for du in off:
        for dv in off:
            acc = acc + sample(float(du), float(dv))
    return (acc / (ss * ss)).reshape(-1, height, width)


def _symmetric_index(n: int, r: int, device):
    """Index of a length-n axis padded by r on both sides in numpy's
    'symmetric' mode (edge sample repeated)."""
    i = np.arange(-r, n + r)
    i = np.where(i < 0, -i - 1, i)
    i = np.where(i >= n, 2 * n - 1 - i, i)
    return torch.as_tensor(i, device=device)


def render_frames_device(
    model: GenericModel,
    board: Board,
    family: TagFamily,
    poses,
    ss: int = 3,
    noise: float = 2.0,
    generator: torch.Generator | None = None,
    blur_sigma: float = 0.7,
    device="cpu",
):
    """Render a pose sequence (F, 6) on ``device``; returns (F, H, W)
    uint8 there, ready for ``TagDetector.detect_batch(None, board,
    dev_images=...)``.

    Rendering runs in float32 (the output is 8-bit-quantized anyway);
    sensor noise (``noise`` gray levels, Gaussian) is drawn from
    ``generator``, which a nonzero ``noise`` requires.
    """
    if noise > 0 and generator is None:
        raise ValueError("render_frames_device: noise needs a generator")
    f32 = torch.float32
    tex, (ox, oy), scale = board_pattern_image(board, family)
    radius = max(1, int(4.0 * blur_sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / blur_sigma) ** 2)
    kern = (k / k.sum()).astype(np.float32)
    H, W = int(model.height), int(model.width)
    params = torch.as_tensor(model.params, dtype=f32, device=device)
    tex_t = torch.as_tensor(tex, dtype=f32, device=device)
    poses_t = torch.as_tensor(np.asarray(poses), dtype=f32, device=device)
    rows = _symmetric_index(H, radius, device)
    cols = _symmetric_index(W, radius, device)
    out = torch.empty((poses_t.shape[0], H, W), dtype=torch.uint8, device=device)
    for lo in range(0, poses_t.shape[0], FRAMES_PER_PASS):
        imgs = _render(
            model.name, params, poses_t[lo : lo + FRAMES_PER_PASS], tex_t,
            float(np.float32(ox)), float(np.float32(oy)),
            float(np.float32(scale)), W, H, ss,
        )
        # separable Gaussian PSF with symmetric borders
        p = imgs.index_select(1, rows)
        imgs = sum(float(kern[i]) * p[:, i : i + H, :] for i in range(len(kern)))
        p = imgs.index_select(2, cols)
        imgs = sum(float(kern[i]) * p[:, :, i : i + W] for i in range(len(kern)))
        if noise > 0:
            n = torch.randn(
                imgs.shape, generator=generator, device=generator.device, dtype=f32
            )
            imgs = imgs + n.to(device) * noise
        # quantize to integer gray levels like a real 8-bit sensor
        out[lo : lo + imgs.shape[0]] = torch.round(torch.clamp(imgs, 0, 255)).to(
            torch.uint8
        )
    return out


def gt_corners(model: GenericModel, board: Board, rvec, tvec):
    """Exact projected corner positions + visibility mask (host float64)."""
    R = se3.exp_so3(torch.as_tensor(np.asarray(rvec), dtype=F64)).numpy()
    pc = board.p3d @ R.T + np.asarray(tvec)
    p2d, valid = model.project(pc)
    valid = valid & (pc[:, 2] > 0)
    inside = (
        (p2d[:, 0] >= 0)
        & (p2d[:, 0] < model.width)
        & (p2d[:, 1] >= 0)
        & (p2d[:, 1] < model.height)
    )
    return p2d, valid & inside


def front_view_base():
    """Base board->camera rotation for a camera facing the printed side:
    viewed from the front, board +x points left and +y up, i.e. the print
    is on the board's -z face and the front view is R0 = rot_z(pi)."""
    return np.array([0.0, 0.0, np.pi])


def default_sequence_poses(n_frames: int, board: Board, seed: int = 0, span_scale=1.0):
    """Handheld-like pose sweep keeping the board in view (front side)."""
    rng = np.random.default_rng(seed)
    span = float(
        (board.p3d[:, :2].max(0) - board.p3d[:, :2].min(0)).max()
    ) * span_scale
    center = board.p3d.mean(0)
    base = torch.as_tensor(front_view_base(), dtype=F64)
    zero = torch.zeros(3, dtype=F64)
    poses = []
    while len(poses) < n_frames:
        pert = rng.normal(size=3) * np.array([0.3, 0.3, 0.5])
        rv, _ = se3.compose(torch.as_tensor(pert, dtype=F64), zero, base, zero)
        rvec = rv.numpy()
        dist = rng.uniform(0.55, 1.15) * span
        offset = rng.normal(size=2) * 0.25 * span
        R = se3.exp_so3(rv).numpy()
        t = np.array([offset[0], offset[1], dist]) - R @ center
        pc = board.p3d @ R.T + t
        if (pc[:, 2] <= 0.05 * span).any():
            continue
        poses.append(np.concatenate([rvec, t]))
    return np.stack(poses)


def smooth_sequence_poses(
    n_frames: int,
    board: Board,
    seed: int = 0,
    keyframe_every: int = 16,
    span_scale=1.0,
):
    """Continuous handheld-video pose trajectory (front side in view):
    diverse keyposes every ``keyframe_every`` frames, interpolated with
    quaternion slerp (rotation) and cubic-smoothstep blending
    (translation) — a few px/frame of corner motion, like the TUM-VI
    ``dataset-calib-cam1`` recording."""
    from scipy.spatial.transform import Rotation, Slerp

    n_keys = max(2, -(-n_frames // keyframe_every) + 1)
    keys = default_sequence_poses(n_keys, board, seed, span_scale)
    slerp = Slerp(np.arange(n_keys, dtype=np.float64), Rotation.from_rotvec(keys[:, :3]))
    poses = []
    for f in range(n_frames):
        u = f / keyframe_every
        k = min(int(u), n_keys - 2)
        t = u - k
        t = t * t * (3.0 - 2.0 * t)  # smoothstep: C1 at keyframes
        tv = (1 - t) * keys[k, 3:] + t * keys[k + 1, 3:]
        poses.append(np.concatenate([slerp(k + t).as_rotvec(), tv]))
    return np.stack(poses)
