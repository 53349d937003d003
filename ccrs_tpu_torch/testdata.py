"""Synthetic AprilGrid dataset renderer.

Port of ``ccrs_tpu/testdata.py``: every output pixel is inverse-mapped
through the camera model onto the board plane (3x3 supersampled), blurred
by a Gaussian PSF, given sensor noise and quantized to uint8 — on the
device the frames are then detected on.  Poses are generated with numpy on
the host, so a seed gives the same trajectory in both packages.
``write_euroc_dataset`` materializes a EuRoC-layout dataset on disk (PNG
through :mod:`ccrs_tpu_torch.pngio`) for CLI runs; ``python -m
ccrs_tpu_torch.testdata <dir>`` writes one.

Ground truth: the rendered corner positions are exactly
``project(params, T_cam_board . p3d_corner)`` (``gt_corners``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np
import torch

from .board import Board, BoardConfig
from .detect.families import TagFamily, get_family
from .models import GenericModel
from .models.projections import unproject_fn
from .solve import se3
from .utils.profiling import stage

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
    # supersampling offsets rounded to the render dtype, as the pixel grid
    off = torch.as_tensor((np.arange(ss) + 0.5) / ss - 0.5).to(dt).tolist()
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
            acc = acc + sample(du, dv)
    return (acc / (ss * ss)).reshape(-1, height, width)


def render_board_image(
    model: GenericModel,
    board: Board,
    family: TagFamily,
    rvec,
    tvec,
    ss: int = 3,
    noise: float = 0.0,
    seed: int = 0,
    blur_sigma: float = 0.7,
    corner_squares: bool = True,
):
    """Render one frame on the host; returns (H, W) uint8 (numpy).

    The frame is rendered in float64 on the CPU whatever devices the
    machine has, blurred by a Gaussian PSF of ``blur_sigma`` pixels
    (``scipy.ndimage.gaussian_filter``), given ``noise`` gray levels of
    Gaussian sensor noise from ``np.random.default_rng(seed)`` and
    truncated to uint8: the same pixels as the JAX package's function of
    this name for the same arguments.  ``corner_squares`` draws the
    Kalibr-style black squares in the tag gaps."""
    tex, (ox, oy), scale = board_pattern_image(board, family, corner_squares)
    pose = np.concatenate([np.asarray(rvec, np.float64), np.asarray(tvec, np.float64)])
    img = _render(
        model.name,
        torch.as_tensor(np.asarray(model.params), dtype=F64),
        torch.as_tensor(pose[None], dtype=F64),
        torch.as_tensor(tex, dtype=F64),
        ox, oy, scale, int(model.width), int(model.height), ss,
    )[0].numpy()
    if blur_sigma > 0:
        from scipy.ndimage import gaussian_filter

        img = gaussian_filter(img, blur_sigma)
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = img + rng.normal(size=img.shape) * noise
    return np.clip(img, 0, 255).astype(np.uint8)


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
    device="cuda",
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


def write_euroc_dataset(
    out_dir: str,
    model: GenericModel,
    n_frames: int = 40,
    cam_num: int = 1,
    extrinsics=None,
    board: Board = None,
    family: TagFamily = None,
    seed: int = 0,
    noise: float = 2.0,
    span_scale: float = 1.0,
    device="cuda",
):
    """Materialize a EuRoC-layout dataset ({root}/mav0/cam{i}/data/*.png) of
    rendered frames; returns (poses (F,6), model).

    Frames are rendered on ``device`` (camera i's sensor noise drawn from a
    ``torch.Generator`` seeded ``seed * 1000 + i``) and written as 8-bit
    gray PNGs on a thread pool.  Board poses come from
    ``default_sequence_poses(n_frames, board, seed, span_scale)``; camera
    i > 0 sees them through ``extrinsics[i]`` (T_cam_i<-cam0), by default
    ``default_rig_extrinsics(cam_num)``.
    """
    from .pngio import write_png

    board = board or Board(BoardConfig())
    family = family or get_family("t36h11")
    poses = default_sequence_poses(n_frames, board, seed=seed, span_scale=span_scale)
    if cam_num > 1 and extrinsics is None:
        extrinsics = default_rig_extrinsics(cam_num)
    with cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for ci in range(cam_num):
            d = os.path.join(out_dir, "mav0", f"cam{ci}", "data")
            os.makedirs(d, exist_ok=True)
            cam_poses = torch.as_tensor(poses, dtype=F64)
            if extrinsics is not None and ci > 0:
                e = torch.as_tensor(np.asarray(extrinsics[ci]), dtype=F64)
                rv, tv = se3.compose(
                    e[:3].expand(n_frames, 3), e[3:].expand(n_frames, 3),
                    cam_poses[:, :3], cam_poses[:, 3:],
                )
                cam_poses = torch.cat([rv, tv], dim=1)
            gen = torch.Generator(device=device).manual_seed(seed * 1000 + ci)
            with stage("render"):
                imgs = render_frames_device(
                    model, board, family, cam_poses.numpy(), noise=noise,
                    generator=gen if noise > 0 else None, device=device,
                ).cpu().numpy()
            with stage("png_write"):
                futures = [
                    pool.submit(
                        write_png,
                        os.path.join(d, f"{10_000_000_000 + f * 100_000_000}.png"),
                        imgs[f],
                    )
                    for f in range(n_frames)
                ]
                for fut in futures:
                    fut.result()
    return poses, model


def default_rig_extrinsics(cam_num: int):
    """T_cam_i<-cam0 for a simple horizontal rig (11 cm baseline steps,
    slight convergence), row 0 identity; rows are (rvec|tvec)."""
    out = [np.zeros(6)]
    for i in range(1, cam_num):
        out.append(
            np.array([0.0, -0.02 * i, 0.005 * i, -0.11 * i, 0.002 * i, 0.004 * i])
        )
    return np.stack(out)


def _rig_camera_points(ext, poses, p3d):
    """Board points in each camera's frame: ext (C, 6) T_cam_i<-cam0, poses
    (F, 6) board->cam0, p3d (N, 3) -> (C, F, N, 3)."""
    C, F = ext.shape[0], poses.shape[0]
    e = ext[:, None, :].expand(C, F, 6)
    po = poses[None].expand(C, F, 6)
    rv, tv = se3.compose(e[..., :3], e[..., 3:], po[..., :3], po[..., 3:])
    return se3.transform(rv, tv, p3d)


def rig_problem(n_cams: int = 8, n_frames: int = 1000, vis_frac: float = 0.75,
                seed: int = 0, noise_px: float = 0.1, device="cuda") -> dict:
    """The synthetic joint-BA problem of ``bench_multicam.py``: ``n_cams``
    EUCM cameras (tumvi-like, each perturbed by 1%) on the horizontal rig
    of ``default_rig_extrinsics`` see the default 6x6 board in
    ``n_frames`` poses; cameras past the first see a frame with
    probability ``vis_frac``; observations carry ``noise_px`` Gaussian
    noise per axis, and a camera's frame counts with at least 24 corners
    inside the 512x512 image.  The random draws are numpy's from ``seed``;
    the geometry runs on ``device`` through ``se3`` and ``project_eucm``.

    Returns a dict: ``args``, the float64 tensors of ``ba_solve_multi``
    after ``project_fn`` (theta0, ext0 and poses0 perturbed as a
    per-camera calibration would hand them over), and the ground truth
    ``gt_params`` (C, 6), ``rig`` (C, 6) as numpy arrays."""
    from .board import create_default_6x6_board
    from .models.projections import project_eucm

    rng = np.random.default_rng(seed)
    C, F = n_cams, n_frames

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    p3d = t(create_default_6x6_board().p3d)
    N = p3d.shape[0]
    gt_params = np.stack([
        np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
        * (1 + 0.01 * rng.standard_normal(6) * [1, 1, 0.2, 0.2, 0.5, 0.5])
        for _ in range(C)
    ])
    rig = default_rig_extrinsics(C)
    perts = t(rng.normal(size=(F, 3)) * 0.25)
    dists = t(rng.uniform(0.5, 1.1, F))

    zeros = torch.zeros_like(perts)
    rv, _ = se3.compose(perts, zeros, t(front_view_base()).expand(F, 3), zeros)
    tv = torch.stack([zeros[:, 0], zeros[:, 0], dists], dim=1) - (
        se3.exp_so3(rv) @ p3d.mean(0)
    )
    poses = torch.cat([rv, tv], dim=1)
    pc = _rig_camera_points(t(rig), poses, p3d)
    pr, valid = project_eucm(t(gt_params)[:, None, None, :], pc)
    inside = (
        valid & (pr[..., 0] >= 0) & (pr[..., 0] < 512)
        & (pr[..., 1] >= 0) & (pr[..., 1] < 512)
    )
    pr = pr + t(rng.normal(size=(C, F, N, 2)) * noise_px)
    p2d = torch.where(inside[..., None], pr, torch.zeros_like(pr))
    sel = np.ones((C, F), bool)
    sel[1:] = rng.uniform(size=(C - 1, F)) < vis_frac
    sel = torch.as_tensor(sel, device=device)
    w = inside & sel[:, :, None]
    cam_frame_valid = (sel & (w.sum(2) >= 24)).to(F64)
    frame_valid = (cam_frame_valid.sum(0) > 0).to(F64)

    theta0 = gt_params * (1 + 0.01 * rng.standard_normal(gt_params.shape))
    ext0 = np.concatenate([np.zeros((1, 6)), rig[1:] + rng.normal(size=(C - 1, 6)) * 5e-3])
    poses0 = poses + t(rng.normal(size=(F, 6)) * 5e-3)
    args = (
        t(theta0), t(ext0), poses0, p3d, p2d, w.to(F64),
        t(np.tile([0, 0, 0, 0, 1e-6, 1e-6], (C, 1))),
        t(np.tile([1e4, 1e4, 512, 512, 1, 10], (C, 1))),
        torch.ones((C, 6), dtype=F64, device=device), cam_frame_valid, frame_valid,
    )
    return {"args": args, "gt_params": gt_params, "rig": rig}


def rig_errors(problem: dict, res) -> dict:
    """A joint solution against ``rig_problem``'s ground truth, as
    ``bench_multicam.py`` judges it: the largest focal error over 190 px,
    the largest extrinsic component error, and the weighted reprojection
    RMS per axis in px (0.1 px of injected noise puts it near 0.1)."""
    from .models.projections import project_eucm

    _, _, _, p3d, p2d, w = problem["args"][:6]
    theta, ext = res.theta.cpu().numpy(), res.ext.cpu().numpy()
    pc = _rig_camera_points(res.ext.to(p3d.device), res.poses.to(p3d.device), p3d)
    pr, _ = project_eucm(res.theta.to(p3d.device)[:, None, None, :], pc)
    r2 = ((pr - p2d) ** 2).sum(-1)
    return {
        "focal_rel_err": float(np.abs(theta[:, :2] - problem["gt_params"][:, :2]).max() / 190.0),
        "ext_err": float(np.abs(ext[1:] - problem["rig"][1:]).max()),
        "rms_px": float(torch.sqrt((r2 * w).sum() / (2.0 * w.sum()))),
        "residuals": int(w.sum()) * 2,
    }


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="render a synthetic EuRoC dataset")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cam-num", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--platform",
        default="cuda",
        choices=["auto", "cpu", "cuda"],
        help="device to render on (default cuda; auto means the same; only "
        "cpu renders on the CPU)",
    )
    args = ap.parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--platform {args.platform}: no CUDA device available")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    write_euroc_dataset(
        os.path.join(args.out_dir, "dataset"),
        model,
        n_frames=args.frames,
        cam_num=args.cam_num,
        seed=args.seed,
        device="cpu" if args.platform == "cpu" else "cuda",
    )
    print(f"wrote {args.frames} frames to {args.out_dir}/dataset (EuRoC layout)")


if __name__ == "__main__":
    _main()
