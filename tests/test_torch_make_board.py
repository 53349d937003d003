"""The port's board generator, ``python -m ccrs_tpu_torch.make_board``,
against the JAX package's ``tools/make_board.py``.

Both tools run as subprocesses at ``--dpi 72`` (small files): the PNGs hold
equal pixels (tolerance 0) and the printed lines are the same, for the
default 6x6 board and for a 1x1 board.  With ``jax``, ``imageio`` and
``PIL`` blocked from import the port's tool still writes the PNG, skips
the PDF and exits 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ccrs_tpu_torch.pngio import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOARDS = {
    "default": [],
    "1x1": ["--rows", "1", "--cols", "1", "--tag-size", "0.1", "--first-id", "7"],
    "3x4_wide_gap": ["--rows", "3", "--cols", "4", "--spacing", "0.25"],
}


def _run(cmd, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("name", list(BOARDS))
def test_board_png_equals_the_reference_tools(tmp_path, name):
    args = BOARDS[name] + ["--dpi", "72"]
    ref = _run([sys.executable, os.path.join(REPO, "tools", "make_board.py"), "ref.png"] + args,
               tmp_path)
    assert ref.returncode == 0, ref.stderr
    port = _run([sys.executable, "-m", "ccrs_tpu_torch.make_board", "port.png"] + args, tmp_path)
    assert port.returncode == 0, port.stderr
    a, b = read_png(str(tmp_path / "ref.png")), read_png(str(tmp_path / "port.png"))
    assert b.dtype == np.uint8 and b.ndim == 2 and set(np.unique(b)) == {0, 255}
    np.testing.assert_array_equal(b, a)
    assert port.stdout.replace("port.", "ref.") == ref.stdout
    h, w = b.shape
    assert f"{w}x{h} px" in port.stdout
    assert (tmp_path / "port.pdf").exists() == (tmp_path / "ref.pdf").exists()


_BLOCKED = r"""
import sys
for mod in ("jax", "imageio", "imageio.v3", "PIL", "cv2"):
    sys.modules[mod] = None  # importing any of them now raises ImportError
from ccrs_tpu_torch.make_board import main
main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m == "ccrs_tpu" or m.startswith("ccrs_tpu."))
assert not bad, bad
"""


def test_runs_without_jax_imageio_and_pil(tmp_path):
    out = _run([sys.executable, "-c", _BLOCKED, "b.png", "--dpi", "72", "--rows", "2", "--cols", "2"],
               tmp_path)
    assert out.returncode == 0, out.stderr
    assert "wrote b.png" in out.stdout and "(pdf skipped" in out.stdout
    assert not (tmp_path / "b.pdf").exists()
    img = read_png(str(tmp_path / "b.png"))
    w, h = out.stdout.split(": ")[1].split(" px")[0].split("x")
    assert img.shape == (int(h), int(w))


def test_print_image_keeps_the_tag_size_exact():
    """A tag spans a whole number of pixels at the effective dpi."""
    from ccrs_tpu_torch.board import Board, BoardConfig
    from ccrs_tpu_torch.detect import get_family
    from ccrs_tpu_torch.make_board import board_print_image

    fam = get_family("t36h11")
    img, dpi = board_print_image(Board(BoardConfig()), fam, 150)
    tag_px = 0.088 * dpi / 0.0254
    assert abs(tag_px - round(tag_px)) < 1e-9 and abs(dpi / 150 - 1) < 0.1
    assert img.shape[0] == img.shape[1]
