"""Example: detect -> PnP -> undistort (counterpart of the reference's
``examples/test_pnp.rs`` and ``ccrs_tpu``'s ``examples/test_pnp.py``).

Detects AprilGrid tags in a fisheye frame, solves the board pose through
the calibrated EuRoC cam0 UCM, prints the reprojection consistency, and
writes an undistorted 1024 x 1024 view, ``remaped_euroc.png``, to the
working directory.  Without an image a synthetic EuRoC-like frame is
rendered on the host by ``testdata.render_board_image``, as the JAX
package's example renders it.

Usage:
  python -m ccrs_tpu_torch.examples.test_pnp [image.png] [--platform cuda|cpu]
"""

import argparse

import numpy as np
import torch

#: the calibrated EuRoC cam0 UCM (reference examples/test_pnp.rs:14)
EUROC_UCM = [471.019, 470.243, 367.122, 246.741, 0.67485]
NEW_WH = 1024


def main(argv=None):
    from ..board import create_default_6x6_board
    from ..detect import TagDetector
    from ..models import GenericModel
    from ..models.undistort import (
        estimate_new_camera_matrix_for_undistort,
        init_undistort_map,
        remap,
    )
    from ..pngio import read_png, write_png
    from ..solve.pnp import solve_pnp_planar
    from ..types import RvecTvec
    from .convert_model import _gray_u8

    ap = argparse.ArgumentParser(description="detect, solve the board pose, undistort")
    ap.add_argument("image", nargs="?")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to run on (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device available")
    device = args.platform

    board = create_default_6x6_board()
    model = GenericModel("ucm", EUROC_UCM, 752, 480)
    if args.image:
        img = _gray_u8(read_png(args.image))
    else:
        from ..detect import get_family
        from ..testdata import default_sequence_poses, render_board_image

        pose = default_sequence_poses(1, board, seed=2)[0]
        img = render_board_image(model, board, get_family("t36h11"), pose[:3], pose[3:])

    tags = TagDetector("t36h11", device=device).detect(img)
    print(f"detected {len(tags)} tags")

    # gather 3D-2D correspondences, unproject, PnP
    p3ds, p2ds = [], []
    for tid, corners in tags.items():
        for c in range(4):
            cid = tid * 4 + c
            if 0 <= cid < board.n_corners:
                p3ds.append(board.p3d[cid])
                p2ds.append(corners[c])
    p3ds, p2ds = np.asarray(p3ds, dtype=np.float64), np.asarray(p2ds, dtype=np.float64)
    rays, valid = model.unproject(p2ds)
    obs = rays[:, :2] / rays[:, 2:3]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    r, tv = solve_pnp_planar(t(p3ds), t(obs), t(valid.astype(np.float64)))
    r, tv = r.cpu().numpy(), tv.cpu().numpy()
    print("r", r)
    print("t", tv)

    # reprojection check
    proj, _ = model.project(RvecTvec(r, tv).transform(p3ds))
    err = np.linalg.norm(proj - p2ds, axis=1)
    print(f"reprojection err: mean {err.mean():.3f} px, max {err.max():.3f} px")

    K = estimate_new_camera_matrix_for_undistort(model, 1.0, (NEW_WH, NEW_WH), device=device)
    xmap, ymap = init_undistort_map(model, K, (NEW_WH, NEW_WH), device=device)
    out = remap(img, xmap, ymap)
    write_png("remaped_euroc.png", out.cpu().numpy().astype(np.uint8))
    print("wrote remaped_euroc.png")


if __name__ == "__main__":
    main()
