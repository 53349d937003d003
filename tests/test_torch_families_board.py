"""The tag families, custom boards and the CLI's ``--board-config``: the
port against the JAX package on the CPU.

- The detector on the three other distributable families (``t16h5``,
  ``t25h9``, ``t36h11b1``), one rendered 512x512 frame each, tracked and
  cold, and on a 5x9 board whose first tag id is 36: the same uint8 frame
  into both packages, ids exact, corners within 1e-3 px (float32 sampling
  summed in another order; measured 1.2e-4 px at most);
- ``family_from_table`` (cell bits and packed words) builds the JAX
  package's family; ``t25h7`` is refused by name and reached only through a
  table, also from the CLI's parser;
- the CLI with ``--board-config`` on 24 frames of a 5x9 board: the port's
  CLI detects as the JAX detector does (masks exact; 99.9% of the corners
  within 1e-3 px, all within 5e-2 px), and the JAX CLI solves the port's
  cached detections.  The problem is flat, so both solutions are held as
  ``tests/test_torch_calib_all_models.py`` holds flat problems: against a
  500-iteration float64 LM started from the port's solution, the port's
  median is within 1e-6 px and the JAX package's (its mixed solve stops
  early on flat problems) within 2e-5 px.
"""

import contextlib
import glob
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import Board as JaxBoard
from ccrs_tpu.board import BoardConfig as JaxBoardConfig
from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.cli import main as jax_main
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import families as jax_families
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.solve import se3 as jax_se3
from ccrs_tpu.testdata import front_view_base, render_board_image
from ccrs_tpu_torch.board import Board, BoardConfig
from ccrs_tpu_torch.calib import validation
from ccrs_tpu_torch.calib.frames import FrameBatch
from ccrs_tpu_torch.cli import build_parser, main
from ccrs_tpu_torch.detect import FAMILY_NAMES, TagDetector, get_family
from ccrs_tpu_torch.detect.families import family_from_table
from ccrs_tpu_torch.interop import board_from_ref
from ccrs_tpu_torch.models import GenericModel, model_from_json
from ccrs_tpu_torch.testdata import write_euroc_dataset
from ccrs_tpu_torch.types import RvecTvec
from test_torch_calib_all_models import long_lm
from torch_jax_pin import assert_same_detections, fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
CORNER_TOL = 1e-3  # px
#: over a 24-frame sequence, the share of corners within CORNER_TOL and the
#: bound on all: an ill-conditioned corner moves by up to a few 1e-2 px when
#: its float32 window sums change in the last bit (ROADMAP.md, C; measured
#: here: 1 of 2,148 corners 1.25e-3 px apart, the others within 3.3e-4)
CORNER_SHARE = 0.999
CORNER_MAX = 5e-2
MEDIAN_TOL = 1e-6  # px, the port against a converged float64 LM
JAX_MEDIAN_TOL = 2e-5  # px, the JAX package's mixed solve on a flat problem


def frame_of(jb, fam, rot, depth):
    """One 512x512 uint8 frame of board ``jb`` (JAX objects), rendered by
    the JAX package: a front view turned by ``rot``, ``depth`` m away."""
    model = JaxModel("eucm", GT, 512, 512)
    rv, _ = jax_se3.compose(jnp.asarray(rot), jnp.zeros(3), jnp.asarray(front_view_base()),
                            jnp.zeros(3))
    rvec = np.asarray(rv)
    R = np.asarray(jax_se3.exp_so3(jnp.asarray(rvec)))
    t = np.array([0.0, 0.0, depth]) - R @ jb.p3d.mean(0)
    return np.asarray(render_board_image(model, jb, fam, rvec, t))[None].astype(np.uint8)


def detect_both(name, jb, img, track):
    want = JaxDetector(name, track=track).detect_batch(img, board=jb)
    got = TagDetector(name, track=track, device="cpu").detect_batch(img, board=board_from_ref(jb))
    return got, want


@pytest.mark.parametrize("track", [False, True], ids=["cold", "tracked"])
@pytest.mark.parametrize("name", ["t16h5", "t25h9", "t36h11b1"])
def test_other_families_match_jax(name, track):
    jb = jax_board()
    img = frame_of(jb, jax_families.get_family(name), [0.12, -0.08, 0.04], 0.5)
    got, want = detect_both(name, jb, img, track)
    n_board_tags = min(36, get_family(name).n_codes)
    assert len(got[0]) >= 0.75 * n_board_tags
    assert_same_detections(got, want, CORNER_TOL)


@pytest.mark.parametrize("track", [False, True], ids=["cold", "tracked"])
def test_5x9_board_with_first_id_36_matches_jax(track):
    jb = JaxBoard(JaxBoardConfig(0.088, 0.3, 5, 9, 36))
    img = frame_of(jb, jax_families.get_family("t36h11"), [0.1, -0.06, 0.03], 0.8)
    got, want = detect_both("t36h11", jb, img, track)
    assert len(got[0]) >= 0.85 * 45 and all(36 <= t < 36 + 45 for t in got[0])
    assert_same_detections(got, want, CORNER_TOL)


def _same_family(a, b):
    assert (a.name, a.size, a.border, a.max_hamming) == (b.name, b.size, b.border, b.max_hamming)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.rotated_codes, b.rotated_codes)


@pytest.mark.parametrize("packed", [False, True], ids=["bits", "packed"])
def test_family_from_table_matches_jax(tmp_path, packed):
    base = get_family("t25h9")  # 5x5 codes stand in for a t25h7 table
    path = tmp_path / "table.npz"
    if packed:  # upstream apriltag words: the MSB is cell 0
        words = np.array([int("".join(map(str, row)), 2) for row in base.codes], np.uint64)
        np.savez(path, codes=words, size=np.int32(5))
    else:
        np.savez(path, codes=base.codes, size=np.int32(5), border=np.int32(2),
                 max_hamming=np.int32(1))
    fam = family_from_table("t25h7", str(path))
    _same_family(fam, jax_families.family_from_table("t25h7", str(path)))
    np.testing.assert_array_equal(fam.codes, base.codes)


def test_t25h7_refused_by_name_and_reached_through_a_table(tmp_path):
    assert "t25h7" not in FAMILY_NAMES and "t25h7" not in jax_families.FAMILY_NAMES
    with pytest.raises(ValueError, match="t25h7"):
        get_family("t25h7")
    with pytest.raises(ValueError, match="t25h7"):
        jax_families.get_family("t25h7")
    path = tmp_path / "t.npz"
    np.savez(path, codes=get_family("t25h9").codes, size=np.int32(5))
    args = build_parser().parse_args(
        ["/nonexistent", "--tag-family", "t25h7", "--tag-family-table", str(path)])
    det = TagDetector(family_from_table(args.tag_family, args.tag_family_table), device="cpu")
    assert det.family.name == "t25h7" and det.family.n_codes == 35


@contextlib.contextmanager
def _in_dir(path, env=None):
    """Run quietly in ``path`` (default_board_config.json lands there) with
    ``env`` set."""
    old_cwd, old_env = os.getcwd(), dict(os.environ)
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield
    finally:
        os.chdir(old_cwd)
        os.environ.clear()
        os.environ.update(old_env)


def _median_of(out, board, batch):
    """The median reprojection error of the solution a CLI wrote to
    ``out`` (cam0.json, cam0_poses.json) on ``batch``."""
    model = model_from_json(str(out / "cam0.json"))
    poses = json.loads((out / "cam0_poses.json").read_text())
    rtvecs = {int(f): RvecTvec.from_json(rt) for f, rt in poses.items()}
    with contextlib.redirect_stdout(io.StringIO()):
        return model, rtvecs, validation(board, batch, model, rtvecs)[1]


def test_cli_board_config_5x9_matches_jax(tmp_path):
    cfg = BoardConfig(tag_size_meter=0.088, tag_spacing=0.3, tag_rows=5, tag_cols=9,
                      first_id=0)
    cfg_path = tmp_path / "board.json"
    cfg_path.write_text(json.dumps(cfg.to_json()))
    board = Board(cfg)
    ds = str(tmp_path / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 512, 512), n_frames=24, seed=8, noise=1.5,
                        board=board, family=get_family("t36h11"), device="cpu")
    cache = str(tmp_path / "cache")
    args = [ds, "--model", "eucm", "--board-config", str(cfg_path), "--no-rerun", "--seed", "2",
            "--detection-cache", cache]
    with _in_dir(tmp_path / "port"):
        main(args + ["--platform", "cpu", "-o", str(tmp_path / "port" / "out")])
    with _in_dir(tmp_path / "jax", {"CCRS_TRACK": "0", "CCRS_SPECULATE": "0"}):
        jax_main(args + ["--no-speculate", "-o", str(tmp_path / "jax" / "out")])
    (path,) = glob.glob(os.path.join(cache, "cam0_*.npz"))
    batch = FrameBatch.load(path)

    # the port CLI's detections against the JAX detector on the same PNGs
    from ccrs_tpu_torch.pngio import read_png

    files = sorted(glob.glob(os.path.join(ds, "mav0", "cam0", "data", "*.png")))
    imgs = np.stack([read_png(f) for f in files])
    jdets = JaxDetector("t36h11").detect_batch(imgs, board=JaxBoard(JaxBoardConfig(
        0.088, 0.3, 5, 9, 0)))
    want = FrameBatch.from_detections(jdets, list(batch.time_ns), board, 512, 512)
    np.testing.assert_array_equal(batch.mask, want.mask)
    d = np.abs(batch.p2d - want.p2d)[batch.mask].max(axis=-1)
    assert (d <= CORNER_TOL).mean() >= CORNER_SHARE and d.max() <= CORNER_MAX, np.sort(d)[-5:]

    model_t, rt_t, med_t = _median_of(tmp_path / "port" / "out", board, batch)
    _, _, med_j = _median_of(tmp_path / "jax" / "out", board, batch)
    _, m_star, rt_star = long_lm(board, batch, model_t, rt_t, 0, 500)
    with contextlib.redirect_stdout(io.StringIO()):
        med_star = validation(board, batch, m_star, rt_star)[1]
    assert med_t < 0.3
    assert abs(med_t - med_star) < MEDIAN_TOL, (med_t, med_star)
    assert abs(med_j - med_star) < JAX_MEDIAN_TOL, (med_j, med_star)
