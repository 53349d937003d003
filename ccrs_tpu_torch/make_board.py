"""Generate a printable AprilGrid board image.

Port of the JAX package's ``tools/make_board.py``: renders the board
texture (tags + Kalibr corner squares) at print resolution and writes a
PNG through :mod:`ccrs_tpu_torch.pngio`, plus a single-page PDF beside it
when PIL is installed.  Same arguments, same pixels, same printed lines.
It runs on the host and needs neither a card nor an image package.

Usage:
  python -m ccrs_tpu_torch.make_board out_board.png [--rows 6 --cols 6 --tag-size 0.088 --spacing 0.3 --first-id 0 --dpi 300]
"""

import argparse
import os

import numpy as np


def board_print_image(board, family, dpi: float):
    """The printable sheet of ``board``: ((H, W) uint8, 0 black and 255
    white, effective dpi).  One texel of the board texture becomes a whole
    number of pixels, so the effective dpi is adjusted to keep the printed
    tag size exact (rounding at texel granularity would otherwise scale the
    whole board by several percent)."""
    from .testdata import board_pattern_image

    tex, _, scale = board_pattern_image(board, family)
    cell_m = 1.0 / scale
    px_per_cell = max(1, int(round(cell_m * dpi / 0.0254)))
    dpi_eff = px_per_cell * 0.0254 / cell_m
    img = np.kron(tex, np.ones((px_per_cell, px_per_cell), np.float32))
    # the texture is stored as seen from the camera side (print on the -z
    # board face); flip horizontally so the printed sheet, viewed directly,
    # is the physical board
    img = img[:, ::-1]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), dpi_eff


def main(argv=None):
    ap = argparse.ArgumentParser(description="write a printable AprilGrid board")
    ap.add_argument("out", help="output .png (a .pdf is written alongside)")
    ap.add_argument("--family", default="t36h11")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--tag-size", type=float, default=0.088, help="meters")
    ap.add_argument("--spacing", type=float, default=0.3)
    ap.add_argument("--first-id", type=int, default=0)
    ap.add_argument("--dpi", type=int, default=300)
    args = ap.parse_args(argv)

    from .board import Board, BoardConfig
    from .detect import get_family
    from .pngio import write_png

    cfg = BoardConfig(args.tag_size, args.spacing, args.rows, args.cols, args.first_id)
    out8, dpi_eff = board_print_image(Board(cfg), get_family(args.family), args.dpi)
    write_png(args.out, out8)
    w_m = out8.shape[1] * 0.0254 / dpi_eff
    print(
        f"wrote {args.out}: {out8.shape[1]}x{out8.shape[0]} px; print at "
        f"{dpi_eff:.2f} dpi for an exact {args.tag_size} m tag "
        f"({w_m:.3f} m wide)"
    )
    # PIL may be missing, or built without the codec its PDF writer needs
    try:
        from PIL import Image

        pdf = os.path.splitext(args.out)[0] + ".pdf"
        Image.fromarray(out8).save(pdf, resolution=dpi_eff)
        print(f"wrote {pdf}")
    except Exception as e:
        print(f"(pdf skipped: {e})")

if __name__ == "__main__":
    main()
