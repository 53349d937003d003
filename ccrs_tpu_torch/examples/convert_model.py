"""Example: model conversion + undistortion (counterpart of the
reference's ``examples/convert_model.rs`` and ``ccrs_tpu``'s
``examples/convert_model.py``).

Loads a calibrated model from JSON, grid-fits a UCM to it, writes
``ucm.json``, and undistorts an image through the converted model to a
1024 x 1024 pinhole view, ``remaped_ucm.png``.  Without an image a
synthetic board frame is rendered through the source model.  Outputs go to
the working directory.

Usage:
  python -m ccrs_tpu_torch.examples.convert_model model.json [image.png]
      [--platform cuda|cpu]
"""

import argparse

import numpy as np
import torch

NEW_WH = 1024


def _gray_u8(img: np.ndarray) -> np.ndarray:
    return (img / 257).astype(np.uint8) if img.dtype == np.uint16 else img


def synthetic_frame(model, device, seed: int = 2) -> np.ndarray:
    """One noiseless board frame through ``model`` (uint8, H x W), one
    sample per pixel."""
    from ..board import create_default_6x6_board
    from ..detect import get_family
    from ..testdata import default_sequence_poses, render_frames_device

    board = create_default_6x6_board()
    pose = default_sequence_poses(1, board, seed=seed)
    frames = render_frames_device(model, board, get_family("t36h11"), pose,
                                  ss=1, noise=0.0, device=device)
    return frames[0].cpu().numpy()


def main(argv=None):
    from ..calib import convert_model
    from ..models import model_from_json, model_to_json, zeros_like_model
    from ..models.undistort import (
        estimate_new_camera_matrix_for_undistort,
        init_undistort_map,
        remap,
    )
    from ..pngio import read_png, write_png

    ap = argparse.ArgumentParser(description="convert a camera model to UCM and undistort")
    ap.add_argument("model_json")
    ap.add_argument("image", nargs="?")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to run on (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device available")
    device = args.platform

    source = model_from_json(args.model_json)
    print(f"source: {source.name} {source.params}")
    target = zeros_like_model("ucm", int(source.width), int(source.height))
    convert_model(source, target, 0, device=device)
    model_to_json("ucm.json", target)
    print(f"converted UCM: {target.params}")

    if args.image:
        img = _gray_u8(read_png(args.image))
    else:
        img = synthetic_frame(source, device)
        print("no image given: rendered a synthetic board frame")
    K = estimate_new_camera_matrix_for_undistort(target, 1.0, (NEW_WH, NEW_WH), device=device)
    xmap, ymap = init_undistort_map(target, K, (NEW_WH, NEW_WH), device=device)
    out = remap(img, xmap, ymap)
    write_png("remaped_ucm.png", out.cpu().numpy().astype(np.uint8))
    print("wrote remaped_ucm.png")


if __name__ == "__main__":
    main()
