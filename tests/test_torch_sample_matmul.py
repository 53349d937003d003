"""The matmul branch of the port's image sampling (ccrs_tpu_torch/detect/
sample.py) against the JAX package's, on the CPU, float32 on both sides.

- ``_band_np``: the band matrices equal the JAX package's bit for bit,
  every tap set, both ``edge`` modes;
- the banded products against the tap loops they encode, both ``edge``
  modes (float32 sums in another order: 1e-3 on 0..255 images);
- each of the four functions, ``use_matmul=True``, against the JAX
  function's ``use_matmul=True`` (``sample_bilinear_mm`` also with
  ``max_rows_mb=1``, many pieces) and against the port's gather branch at
  ``tests/test_sample.py``'s tolerances (maps ``rtol=1e-4, atol=2e-2``,
  refined corners 5e-3 px, samples 1e-2);
- the synthetic saddle within 0.05 px for both branches;
- the dispatch: the tensor's device picks the branch (gather on the CPU
  and on the card, matmul elsewhere), ``use_matmul=`` overrides it,
  ``matmul_branch`` forces one for a block and is restored on exit, also
  after an exception;
- ``refine_decode_fused_dense`` and ``wave_advance`` through the matmul
  branch against the JAX functions through theirs (``_use_mm`` patched,
  traces cleared before and after): ids and masks exact, corners within
  1e-3 px.

Port against JAX, matmul branch on both sides: images 1e-3, maps
``rtol=1e-5, atol=2e-2`` (window sums up to ~1e5 of 49 float32 products,
summed in another order), refined corners 1e-3 px, samples 1e-3.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import decode as JD
from ccrs_tpu.detect import get_family as jax_family
from ccrs_tpu.detect import sample as JS
from ccrs_tpu.detect import track as JT
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.testdata import gt_corners, render_board_image, smooth_sequence_poses
from ccrs_tpu_torch.detect import decode as TD
from ccrs_tpu_torch.detect import get_family
from ccrs_tpu_torch.detect import sample as TS
from ccrs_tpu_torch.detect import track as TT
from ccrs_tpu_torch.interop import wave_carry_from_ref
from torch_jax_pin import assert_same_detections
from torch_jax_pin import fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
#: port against JAX, both through the matmul branch
TOL_JAX = {"unsharp": dict(rtol=0, atol=1e-3), "klt": dict(rtol=1e-5, atol=2e-2),
           "refine": dict(rtol=0, atol=1e-3), "bilinear": dict(rtol=0, atol=1e-3),
           "bilinear_pieces": dict(rtol=0, atol=1e-3)}
#: the port's two branches against each other (tests/test_sample.py)
TOL_BRANCH = {"unsharp": dict(rtol=0, atol=1e-2), "klt": dict(rtol=1e-4, atol=2e-2),
              "refine": dict(rtol=0, atol=5e-3), "bilinear": dict(rtol=0, atol=1e-2),
              "bilinear_pieces": dict(rtol=0, atol=1e-2)}
FUNCS = list(TOL_JAX)


@pytest.fixture(scope="module")
def case():
    """Three random 96x128 uint8-valued frames, 40 refine starts and 600
    sample positions per frame (some off the image), from numpy seeds."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, size=(3, 96, 128)).astype(np.float32)
    B, H, W = imgs.shape
    c0 = np.stack([rng.uniform(8, W - 8, size=(B, 40)), rng.uniform(8, H - 8, size=(B, 40))],
                  axis=-1).astype(np.float32)
    sx = rng.uniform(-2, W + 2, size=(B, 600)).astype(np.float32)
    sy = rng.uniform(-2, H + 2, size=(B, 600)).astype(np.float32)
    # the refine reads the JAX package's float32 maps on both sides
    maps = np.array(JS.build_klt_maps(jnp.asarray(imgs), use_matmul=False))
    return dict(imgs=imgs, c0=c0, sx=sx, sy=sy, maps=maps)


def _port(name, c, mm):
    t = torch.as_tensor
    if name == "unsharp":
        return TS.unsharp_mm(t(c["imgs"]), use_matmul=mm)
    if name == "klt":
        return TS.build_klt_maps(t(c["imgs"]), use_matmul=mm)
    if name == "refine":
        return TS.refine_corners_mm(t(c["maps"]), t(c["c0"]), use_matmul=mm)
    mb = 1 if name == "bilinear_pieces" else 192
    return TS.sample_bilinear_mm(t(c["imgs"]), t(c["sx"]), t(c["sy"]), max_rows_mb=mb,
                                 use_matmul=mm)


def _jax(name, c, mm):
    j = jnp.asarray
    if name == "unsharp":
        return JS.unsharp_mm(j(c["imgs"]), use_matmul=mm)
    if name == "klt":
        return JS.build_klt_maps(j(c["imgs"]), use_matmul=mm)
    if name == "refine":
        return JS.refine_corners_mm(j(c["maps"]), j(c["c0"]), use_matmul=mm)
    mb = 1 if name == "bilinear_pieces" else 192
    return JS.sample_bilinear_mm(j(c["imgs"]), j(c["sx"]), j(c["sy"]), max_rows_mb=mb,
                                 use_matmul=mm)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("which", ["g", "go", "blur"])
@pytest.mark.parametrize("size", [1, 4, 7, 96, 128])
def test_band_matrices_equal_jax_bit_for_bit(size, which, edge):
    got, want = TS._band_np(size, which, edge), JS._band_np(size, which, edge)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    band = TS._band(size, which, edge, torch.device("cpu"))
    assert band.dtype == torch.float32
    np.testing.assert_array_equal(band.numpy(), want)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("which", ["g", "go", "blur"])
def test_banded_products_equal_the_tap_loops(case, which, edge):
    x = torch.as_tensor(case["imgs"])
    taps = {"g": TS._G_TAPS, "go": TS._GO_TAPS, "blur": TS._BLUR_TAPS}[which]
    _, H, W = x.shape
    cpu = torch.device("cpu")
    np.testing.assert_allclose(TS._convy(x, TS._band(H, which, edge, cpu)).numpy(),
                               TS._tap_corr(x, taps, 1, edge).numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(TS._convx(x, TS._band(W, which, edge, cpu)).numpy(),
                               TS._tap_corr(x, taps, 2, edge).numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", FUNCS)
def test_matmul_branch_matches_jax(case, name):
    got = _port(name, case, True)
    assert got.dtype == torch.float32
    want = np.asarray(_jax(name, case, True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX[name])


@pytest.mark.parametrize("name", FUNCS)
def test_branches_agree(case, name):
    a, b = _port(name, case, True), _port(name, case, False)
    assert a.shape == b.shape
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL_BRANCH[name])


def test_klt_maps_layout():
    """The matmul branch's maps are a (B, 7, H, W) view of (B, H, 7, W)
    memory, which the refine product reads as (B, H, 7W) without a copy;
    the gather branch's are contiguous."""
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 16, 24)), dtype=torch.float32)
    mm = TS.build_klt_maps(x, use_matmul=True)
    assert mm.shape == (2, 7, 16, 24) and mm.permute(0, 2, 1, 3).is_contiguous()
    rows = mm.permute(0, 2, 1, 3).reshape(2, 16, 7 * 24)
    assert rows.data_ptr() == mm.data_ptr()
    assert TS.build_klt_maps(x, use_matmul=False).is_contiguous()


@pytest.mark.parametrize("mm", [False, True])
def test_refine_finds_synthetic_saddle(mm):
    """A checkerboard saddle at a known subpixel position: from a ~1.5 px
    off start the refinement lands within 0.05 px (tests/test_sample.py)."""
    H = W = 64
    cx_true, cy_true = 31.3, 32.6
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 127.5 + 127.5 * np.tanh(0.9 * (xx - cx_true)) * np.tanh(0.9 * (yy - cy_true))
    maps = TS.build_klt_maps(torch.as_tensor(img[None]), use_matmul=mm)
    start = torch.tensor([[[cx_true + 1.2, cy_true - 1.4]]], dtype=torch.float32)
    out = TS.refine_corners_mm(maps, start, use_matmul=mm)[0, 0].numpy()
    assert abs(out[0] - cx_true) < 0.05 and abs(out[1] - cy_true) < 0.05, out


def test_dispatch_follows_the_device_and_the_scoped_switch(monkeypatch):
    cpu = torch.zeros(1, 8, 8)
    meta = torch.empty(1, 8, 8, device="meta")
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert TS._use_mm(None, cpu) is False and TS._use_mm(None, meta) is True
    # the card keeps the gather branch (measured slower there), unless forced
    assert TS._use_mm(None, card) is False and TS._use_mm(True, card) is True
    assert TS._use_mm(True, cpu) is True and TS._use_mm(False, meta) is False
    assert TS._mm_dtype() == torch.float32

    calls = []
    real = TS._hat
    monkeypatch.setattr(TS, "_hat", lambda *a: calls.append(1) or real(*a))
    sx = torch.full((1, 3), 2.5)
    TS.sample_bilinear_mm(cpu, sx, sx)
    assert not calls  # a CPU tensor takes the gather branch
    TS.sample_bilinear_mm(cpu, sx, sx, use_matmul=True)
    assert len(calls) == 2
    with TS.matmul_branch(True):
        assert TS._use_mm(None, cpu) is True and TS._use_mm(False, cpu) is False
        TS.sample_bilinear_mm(cpu, sx, sx)
        assert len(calls) == 4
        with TS.matmul_branch(False):
            assert TS._use_mm(None, meta) is False
        assert TS._use_mm(None, cpu) is True
    assert TS._use_mm(None, cpu) is False
    with pytest.raises(ZeroDivisionError):
        with TS.matmul_branch(True):
            1 / 0
    assert TS._forced is None and TS._use_mm(None, cpu) is False


@pytest.fixture
def jax_matmul_branch(monkeypatch):
    """The JAX package's accelerator branch on the CPU: ``_use_mm`` patched
    for this test only, and every trace made under it dropped on both
    sides (the jitted functions key their traces on shapes only)."""
    jax.clear_caches()
    monkeypatch.setattr(JS, "_use_mm", lambda force: True if force is None else bool(force))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _render(n_frames, size=384):
    """n_frames of a slow size x size sequence rendered by the JAX
    package's host renderer (noise from numpy seeds), and their poses."""
    board = jax_board()
    s = size / 512.0
    model = JaxModel("eucm", [p * s for p in GT[:4]] + GT[4:], size, size)
    poses = smooth_sequence_poses(n_frames, board, seed=5, keyframe_every=16)
    imgs = np.stack([
        render_board_image(model, board, jax_family("t36h11"), p[:3], p[3:], noise=1.0, seed=f)
        for f, p in enumerate(poses)
    ])
    return board, model, poses, imgs


def test_refine_decode_through_the_matmul_branch_matches_jax(jax_matmul_branch):
    """Perturbed ground-truth quads through both dense refine + decode
    paths, matmul branch on both sides: ids, rotations, hamming and
    validity exact, corners within 1e-3 px; the primary pass's maps and
    sharpened frames reused by a second decode as the assist does."""
    board, model, poses, imgs = _render(2, size=512)
    rng = np.random.default_rng(0)
    quads = np.zeros((len(imgs), board.n_tags, 4, 2), np.float32)
    qvalid = np.zeros((len(imgs), board.n_tags), bool)
    for f, pose in enumerate(poses):
        p2d, vis = gt_corners(model, board, pose[:3], pose[3:])
        q = p2d.reshape(board.n_tags, 4, 2)[:, [1, 0, 3, 2]]  # clockwise
        quads[f] = q + rng.normal(size=q.shape) * 0.8
        qvalid[f] = vis.reshape(board.n_tags, 4).all(axis=1)
    want = JD.refine_decode_fused_dense(jax_family("t36h11"), jnp.asarray(imgs),
                                        jnp.asarray(quads), jnp.asarray(qvalid))
    with TS.matmul_branch(True):
        got = TD.refine_decode_fused_dense(get_family("t36h11"), torch.as_tensor(imgs),
                                           torch.as_tensor(quads), torch.as_tensor(qvalid))
        again = TD.refine_decode_fused_dense(
            get_family("t36h11"), torch.as_tensor(imgs), torch.as_tensor(quads),
            torch.as_tensor(qvalid), sharp=got["sharp"], maps=got["maps"])
    for k in ("tag_id", "rotation", "hamming", "valid", "contrast_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy(), err_msg=k)
    assert got["valid"].sum() > 0.8 * qvalid.sum()
    np.testing.assert_allclose(got["corners"].numpy(), np.asarray(want["corners"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(again["corners"].numpy(), got["corners"].numpy())


def test_wave_through_the_matmul_branch_matches_jax(jax_matmul_branch):
    """One wave of three rows (row 1 with a third of its seed dropped, row
    2 inactive) from the cold detections of frames 0 and 1, on frame 2,
    matmul branch on both sides: the acc / att / benign masks and the
    carry's masks and ages exact, corners within 1e-3 px."""
    board, _, _, imgs = _render(3)
    cold = JaxDetector("t36h11", track=False).detect_batch(imgs[:2], board=board)
    c1, v1 = JT.detections_to_arrays(cold[1], board)
    c2, v2 = JT.detections_to_arrays(cold[0], board)
    v1b = v1.copy()
    v1b[:12] = False
    carry = JT.init_wave_carry(np.stack([c1] * 3), np.stack([v1, v1b, v1]),
                               np.stack([c2] * 3), np.stack([v2] * 3))
    active = np.array([True, True, False])
    wave_imgs = np.stack([imgs[2]] * 3)
    bxy = board.p3d.reshape(board.n_tags, 4, 3)[:, :, :2].astype(np.float32)
    jc, jo = JT.wave_advance(jax_family("t36h11"), jnp.asarray(wave_imgs), jnp.asarray(bxy),
                             jnp.asarray(np.int32(board.config.first_id)),
                             tuple(jnp.asarray(a) for a in carry), jnp.asarray(active))
    with TS.matmul_branch(True):
        tc, to = TT.wave_advance(get_family("t36h11"), torch.as_tensor(wave_imgs),
                                 torch.as_tensor(bxy), board.config.first_id,
                                 wave_carry_from_ref(carry), torch.as_tensor(active))
    cor, acc, att, ben = (t.numpy() for t in to)
    jcor, jacc, jatt, jben = (np.asarray(a) for a in jo)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(att, jatt)
    np.testing.assert_array_equal(ben, jben)
    assert acc[0].sum() >= len(cold[1]) - 2 and att[2].sum() == 0
    np.testing.assert_allclose(cor[acc], jcor[acc], rtol=0, atol=1e-3)
    for k, (got, want) in enumerate(zip(tc, jc)):
        got, want = got.numpy(), np.asarray(want)
        if got.dtype == np.float32:
            np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3, err_msg=str(k))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(k))


def test_cold_detector_through_the_matmul_branch_matches_jax(jax_matmul_branch):
    """The cold detector on two frames, matmul branch in both packages:
    ids exact, corners within 1e-3 px (the assist pass included)."""
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.interop import board_from_ref

    board, _, _, imgs = _render(2)
    want = JaxDetector("t36h11", track=False).detect_batch(imgs, board=board)
    with TS.matmul_branch(True):
        got = TagDetector("t36h11", track=False, device="cpu").detect_batch(
            imgs, board_from_ref(board))
    assert sum(len(w) for w in want) > 40
    assert_same_detections(got, want, tol=1e-3)
