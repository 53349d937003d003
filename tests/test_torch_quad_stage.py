"""The port's native quad stage (``quads.extract_quad_stage``, one C++ call
per chunk) against the JAX package's ``TagDetector._extract_quads``, the
numpy composition around two native calls that it replaces, bit for bit:
every slot of the quad buffer, valid or not, and the counts.  The
reference unpacks the same packed bitmaps with ``np.unpackbits``.

Inputs: frames of both benchmark configurations rendered by
``benchmark/gen/render.py`` and thresholded by the port (512², 752x480,
752x480 cut to 749x477 so that rows and columns of the bitmap are padded,
1024² on the scale-2 pyramid path and 752x480 forced onto it), with and
without a board; an all-white frame; a drawn bitmap whose dark squares
fill both erosion levels' slots, so the counts reach ``max_quads`` (also
at an odd ``max_quads``); fields of random blobs at random sizes; one
frame; 13 frames.  The thread count changes
no bit, and the stage reports the frames that ran level 2, also through
the cold detector's counters.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board
from ccrs_tpu.detect import detector as jax_detector
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.detect.quads import MAX_QUADS, extract_quad_stage
from ccrs_tpu_torch.detect.threshold import threshold_front
from ccrs_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")

torch.set_num_threads(2)


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _render(config, traffic, n, width=None, height=None, seed=5):
    """n frames of a benchmark configuration's first camera along its
    traffic's first trajectory, at the camera's size unless given."""
    sys.path.insert(0, BENCH)
    try:
        from gen import poses, render
        from gen.board import board_from_config, t36h11
    finally:
        sys.path.remove(BENCH)
    cfg = _config(config)
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    board = board_from_config(cfg)
    cam = cfg["cameras"][0]
    w, h = width or cam["width"], height or cam["height"]
    params = list(cam["params"])
    s = w / cam["width"]
    params[:4] = [p * s for p in params[:4]]
    p = poses.trajectory(n, board.p3d(), tr["trajectory_seeds"][0], tr["span_scale"])
    return render.render(params, w, h, board, t36h11(), p, torch.Generator().manual_seed(seed),
                         tr["noise"])


def _square_field():
    """A 512² bitmap (1 = white) whose dark 8 px squares fill both levels:
    two top rows of squares tied to the top edge by 1 px lines, which only
    the second erosion level cuts (so only level 2 sees those squares, and
    first in raster order), and rows of plain squares below, which level 1
    takes."""
    img = np.ones((512, 512), np.uint8)
    for k in range(42):  # row A, tethers in their own columns
        x = 4 + 12 * k
        img[20:28, x : x + 8] = 0
        img[0:20, x + 3] = 0
    for k in range(41):  # row B, tethers through row A's gaps
        x = 10 + 12 * k
        img[40:48, x : x + 8] = 0
        img[0:40, x + 4] = 0
    for r in range(3):
        for k in range(42):
            x, y = 4 + 12 * k, 80 + 16 * r
            img[y : y + 8, x : x + 8] = 0
    return img


def _pack(bits):
    """(C, H, W) {0, 1} -> the front-end's layout: rows padded to 4, columns
    to 8, white padding, MSB first."""
    C, H, W = bits.shape
    out = np.ones((C, H + (-H) % 4, W + (-W) % 8), np.uint8)
    out[:, :H, :W] = bits
    return np.packbits(out, axis=-1)


_FRAMES = {}


def _frames(name):
    """(packed bitmaps, H, W at the bitmap's scale, scale) of a named input."""
    if name in _FRAMES:
        return _FRAMES[name]
    if name == "tumvi512":
        frames, scale = _render("tumvi-calib-cam1-512", "tumvi512-video", 13), 1
    elif name == "euroc752x480":
        frames, scale = _render("euroc-cam-april-stereo", "euroc-stereo-video", 8), 1
    elif name == "euroc749x477":
        frames, scale = _render("euroc-cam-april-stereo", "euroc-stereo-video", 8)[:, :477, :749], 1
    elif name == "euroc752x480-scale2":
        frames, scale = _render("euroc-cam-april-stereo", "euroc-stereo-video", 8), 2
    elif name == "tumvi1024-scale2":
        frames, scale = _render("tumvi-calib-cam1-512", "tumvi512-video", 3, 1024, 1024), 2
    elif name == "white":
        frames, scale = torch.full((2, 96, 128), 255, dtype=torch.uint8), 1
    else:
        raise KeyError(name)
    H, W = frames.shape[1] // scale, frames.shape[2] // scale
    packed = threshold_front(frames.contiguous(), scale).numpy()
    _FRAMES[name] = (packed, H, W, scale)
    return _FRAMES[name]


def _reference(packed, H, W, scale, board, max_quads=MAX_QUADS):
    """The JAX package's quad stage on the unpacked bitmaps."""
    det = jax_detector.TagDetector(max_quads=max_quads, track=False)
    b1 = np.unpackbits(packed, axis=-1)[:, :H, :W]
    return det._extract_quads(b1, board, scale)


def _same_bits(got, want):
    q, c = got[:2]
    rq, rc = want
    assert q.dtype == rq.dtype == np.float32 and q.shape == rq.shape
    assert np.array_equal(c, rc), (c, rc)
    assert np.array_equal(q.view(np.uint32), rq.view(np.uint32))


BOARD = create_default_6x6_board()

CASES = {
    # name: (input, board, frames, max_quads)
    "tumvi512-13-frames-board": ("tumvi512", BOARD, None, MAX_QUADS),
    "tumvi512-13-frames-no-board": ("tumvi512", None, None, MAX_QUADS),
    "tumvi512-one-frame": ("tumvi512", BOARD, slice(4, 5), MAX_QUADS),
    "euroc752x480-board": ("euroc752x480", BOARD, None, MAX_QUADS),
    "euroc749x477-padded-board": ("euroc749x477", BOARD, None, MAX_QUADS),
    "euroc749x477-padded-no-board": ("euroc749x477", None, None, MAX_QUADS),
    "euroc752x480-scale2-board": ("euroc752x480-scale2", BOARD, None, MAX_QUADS),
    "tumvi1024-scale2-board": ("tumvi1024-scale2", BOARD, None, MAX_QUADS),
    "tumvi1024-scale2-no-board": ("tumvi1024-scale2", None, None, MAX_QUADS),
    "white-board": ("white", BOARD, None, MAX_QUADS),
    "white-no-board": ("white", None, None, MAX_QUADS),
    "small-buffer-board": ("tumvi512", BOARD, slice(0, 5), 24),
    "odd-buffer-no-board": ("tumvi512", None, slice(0, 5), 25),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_equals_the_jax_composition(case):
    name, board, frames, max_quads = CASES[case]
    packed, H, W, scale = _frames(name)
    if frames is not None:
        packed = packed[frames]
    want = _reference(packed, H, W, scale, board, max_quads)
    got = extract_quad_stage(packed, H, W, scale, None if board is None else board.n_tags,
                             max_quads)
    _same_bits(got, want)
    if name == "white":
        assert not got[1].any()
    else:
        assert got[1].min() > 0


@pytest.mark.parametrize("max_quads", [MAX_QUADS, MAX_QUADS + 1])
@pytest.mark.parametrize("board", [None, BOARD], ids=["no-board", "board"])
@pytest.mark.parametrize("scale", [1, 2])
def test_both_levels_full(max_quads, board, scale):
    """Level 1 fills its half of the buffer with the plain squares; without
    a board level 2 fills the other half with the tied squares, none of
    them near a level-1 quad, so the count reaches 2 x (max_quads // 2).
    With a board (36 tags, no big quad) level 2 is skipped."""
    field = _square_field()
    bits = np.stack([field, field[:, ::-1]])
    packed = _pack(bits)  # at scale 2 the same squares, as a pyramid level's
    H, W = bits.shape[1:]
    want = _reference(packed, H, W, scale, board, max_quads)
    got = extract_quad_stage(packed, H, W, scale, None if board is None else board.n_tags,
                             max_quads)
    _same_bits(got, want)
    half = max_quads // 2
    assert (got[1] == (2 * half if board is None else half)).all(), got[1]
    assert got[2] == (2 if board is None else 0)


@pytest.mark.parametrize("seed", range(8))
def test_random_fields_equal_the_jax_composition(seed):
    """Blobs of every size at random frame sizes (runs across 64-pixel
    words, blobs on the frame's edges, shapes that are no quad): three
    frames of a box-filtered uniform field cut at a random quantile, with
    and without a board, at both scales."""
    from scipy.ndimage import uniform_filter

    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(9, 300)), int(rng.integers(9, 300))
    field = uniform_filter(rng.random((3, H, W)), size=(1,) + (int(rng.integers(1, 9)),) * 2)
    packed = _pack((field > np.quantile(field, rng.uniform(0.2, 0.8))).astype(np.uint8))
    for board in (None, BOARD):
        for scale in (1, 2):
            got = extract_quad_stage(packed, H, W, scale,
                                     None if board is None else board.n_tags)
            _same_bits(got, _reference(packed, H, W, scale, board))


def _level2_frames(packed, H, W, scale, board, monkeypatch):
    """Frames the JAX composition sends through its second native call."""
    seen = []
    real = jax_detector.extract_quads_batch

    def spy(binary, **kw):
        seen.append(binary.shape[0])
        return real(binary, **kw)

    monkeypatch.setattr(jax_detector, "extract_quads_batch", spy)
    _reference(packed, H, W, scale, board)
    monkeypatch.undo()
    return seen[1] if len(seen) > 1 else 0


@pytest.mark.parametrize("name", ["tumvi512", "euroc752x480", "tumvi1024-scale2", "white"])
@pytest.mark.parametrize("board", [None, BOARD], ids=["no-board", "board"])
def test_stage_reports_its_level2_frames(name, board, monkeypatch):
    packed, H, W, scale = _frames(name)
    want = _level2_frames(packed, H, W, scale, board, monkeypatch)
    got = extract_quad_stage(packed, H, W, scale, None if board is None else board.n_tags)
    assert got[2] == want
    if board is None:
        assert got[2] == packed.shape[0]


_THREADS_SCRIPT = r"""
import sys
import numpy as np
from ccrs_tpu_torch.detect.quads import extract_quad_stage
d = np.load(sys.argv[1])
q, c, l2 = extract_quad_stage(d["packed"], int(d["H"]), int(d["W"]), int(d["scale"]),
                              int(d["n_tags"]) if int(d["n_tags"]) >= 0 else None)
np.savez(sys.argv[2], quads=q, counts=c, level2=l2)
"""


@pytest.mark.parametrize("name", ["tumvi512", "tumvi1024-scale2"])
def test_thread_count_changes_no_bit(name, tmp_path):
    """OMP_NUM_THREADS=1 and 3 in fresh processes give this process's
    output (the default thread count), bit for bit."""
    packed, H, W, scale = _frames(name)
    inp = tmp_path / "in.npz"
    np.savez(inp, packed=packed, H=H, W=W, scale=scale, n_tags=BOARD.n_tags)
    want = extract_quad_stage(packed, H, W, scale, BOARD.n_tags)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for threads in ("1", "3"):
        env["OMP_NUM_THREADS"] = threads
        out = tmp_path / f"out{threads}.npz"
        run = subprocess.run([sys.executable, "-c", _THREADS_SCRIPT, str(inp), str(out)],
                             capture_output=True, text=True, env=env, timeout=240)
        assert run.returncode == 0, run.stderr[-3000:]
        got = np.load(out)
        _same_bits((got["quads"], got["counts"]), want[:2])
        assert int(got["level2"]) == want[2]


def test_cold_detector_counts_its_quad_frames(monkeypatch):
    """The cold detector's counters: every frame through the quad stage,
    and the frames that ran level 2, as the stage itself reports them."""
    frames = _render("tumvi-calib-cam1-512", "tumvi512-video", 6)
    packed, H, W, scale = threshold_front(frames, 1).numpy(), 512, 512, 1
    level2 = extract_quad_stage(packed, H, W, scale, BOARD.n_tags)[2]
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.reset()
    try:
        det = TagDetector(track=False, device="cpu")
        det.chunk = 4
        det.detect_batch(None, board=BOARD, dev_images=frames)
        c = profiling.counters()
    finally:
        profiling.reset()
    assert c["detect/quad-frames"] == 6
    assert c.get("detect/quad-level2", 0) == level2
