"""Undistortion of the port against the JAX package's, on the CPU.

The same models go through both packages' ``estimate_new_camera_matrix_for
_undistort`` (K within 1e-12 relative), ``init_undistort_map`` (maps within
1e-4 px) and ``remap`` (gray and colour images and out-of-range map
entries, equal pixel for pixel: XLA contracts the remap's sums into fused
multiply-adds, and the port evaluates the same expression, each rounded
once as a fused multiply-add rounds it).
Also the JAX file's checks on the port alone: the map pulls each pixel from
the model's projection of its pinhole ray, and detected board rows become
straight after undistortion.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.models import undistort as jax_undistort
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.models.undistort import (
    estimate_new_camera_matrix_for_undistort,
    init_undistort_map,
    remap,
)
from ccrs_tpu_torch.testdata import default_sequence_poses, render_frames_device

torch.set_num_threads(2)

EUCM = ("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512)
UCM = ("ucm", [200.0, 200.0, 128.0, 128.0, 0.6], 256, 256)
KB4 = ("kb4", [190.0, 190.5, 254.0, 256.0, 0.01, -0.005, 0.002, -0.001], 512, 512)


def both(spec):
    return GenericModel(*spec), JaxModel(*spec)


def board_frame(model, seed=5):
    board = create_default_6x6_board()
    pose = default_sequence_poses(1, board, seed=seed)
    img = render_frames_device(model, board, get_family("t36h11"), pose, noise=0.0,
                               device="cpu")[0].numpy()
    return board, pose[0], img


@pytest.mark.parametrize("spec", [EUCM, UCM, KB4], ids=lambda s: s[0])
@pytest.mark.parametrize("balance,size", [(1.0, (512, 512)), (0.5, (1024, 768)), (0.0, (128, 128))])
def test_camera_matrix_and_maps_match_jax(spec, balance, size):
    m, jm = both(spec)
    K = estimate_new_camera_matrix_for_undistort(m, balance, size, device="cpu")
    jK = jax_undistort.estimate_new_camera_matrix_for_undistort(jm, balance, size)
    np.testing.assert_allclose(K, jK, rtol=1e-12, atol=0)
    xmap, ymap = init_undistort_map(m, K, size, device="cpu")
    jx, jy = jax_undistort.init_undistort_map(jm, jK, size)
    assert xmap.dtype == torch.float32 and tuple(xmap.shape) == (size[1], size[0])
    np.testing.assert_allclose(xmap.numpy(), jx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ymap.numpy(), jy, rtol=0, atol=1e-4)


def test_undistort_map_pinhole_consistency():
    m = GenericModel(*EUCM)
    K = estimate_new_camera_matrix_for_undistort(m, 1.0, (512, 512), device="cpu")
    assert K[0, 0] > 0 and K[0, 2] > 0
    xmap, ymap = init_undistort_map(m, K, (512, 512), device="cpu")
    u, v = 300, 200
    ray = np.linalg.inv(K) @ np.array([u, v, 1.0])
    p2d, valid = m.project(ray[None, :])
    assert valid[0]
    np.testing.assert_allclose([float(xmap[v, u]), float(ymap[v, u])], p2d[0], atol=1e-4)


def test_remap_edges_and_out_of_range_match_jax():
    """Map entries on and beyond the image edges (-1 is the value of a ray
    the model cannot project): both remaps clip and zero them alike."""
    rng = np.random.default_rng(1)
    H, W = 48, 64
    img = rng.integers(0, 256, (H, W), np.uint8)
    xs = np.array([-1.0, -1e-3, 0.0, 0.4, W - 1.001, W - 1.0005, W - 1.0, W - 0.999, W + 3.0])
    ys = np.array([-1.0, 0.0, 0.7, H - 1.001, H - 1.0, H - 0.5])
    jx, jy = (a.astype(np.float32) for a in np.meshgrid(xs, ys))
    jx = np.concatenate([jx, rng.uniform(-2, W + 1, (40, xs.size)).astype(np.float32)])
    jy = np.concatenate([jy, rng.uniform(-2, H + 1, (40, xs.size)).astype(np.float32)])
    got = remap(img, torch.as_tensor(jx), torch.as_tensor(jy)).numpy()
    np.testing.assert_array_equal(got, jax_undistort.remap(img, jx, jy))
    assert (got[jx < 0] == 0).all() and (got[jx > W - 1] == 0).all()


@pytest.mark.parametrize("spec", [EUCM, UCM], ids=lambda s: s[0])
def test_remap_matches_jax_gray_and_colour(spec):
    """The same maps and images into both remaps: equal pixel for pixel, for
    a rendered gray frame and a random colour image."""
    m, jm = both(spec)
    K = jax_undistort.estimate_new_camera_matrix_for_undistort(jm, 0.5, (300, 200))
    jx, jy = jax_undistort.init_undistort_map(jm, K, (300, 200))
    xmap, ymap = torch.as_tensor(jx), torch.as_tensor(jy)
    _, _, gray = board_frame(m)
    colour = np.random.default_rng(0).integers(0, 256, gray.shape + (3,), np.uint8)
    for img in (gray, colour):
        got = remap(img, xmap, ymap)
        want = jax_undistort.remap(img, jx, jy)
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # a tensor image on the maps' device gives the same pixels
    assert torch.equal(remap(torch.as_tensor(gray), xmap, ymap), remap(gray, xmap, ymap))


@pytest.mark.parametrize("shape", [(60, 80), (60, 80, 3)], ids=["gray", "colour"])
def test_remap_bool_matches_jax(shape):
    """A bool mask: gray comes back as uint8 0/1, colour as bool (the JAX
    ``remap`` casts a colour image back to its own dtype).  Bit-exact."""
    rng = np.random.default_rng(2)
    img = rng.random(shape) > 0.5
    jx = rng.uniform(-2, 82, (50, 70)).astype(np.float32)
    jy = rng.uniform(-2, 62, (50, 70)).astype(np.float32)
    got = remap(img, torch.as_tensor(jx), torch.as_tensor(jy)).numpy()
    want = jax_undistort.remap(img, jx, jy)
    assert got.dtype == want.dtype == (np.uint8 if len(shape) == 2 else np.bool_)
    np.testing.assert_array_equal(got, want)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.asarray(c).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """``_fma`` is a fused multiply-add: p * q + r rounded once to float32,
    also where a float64 sum rounded to float32 would round twice (the first
    case: the sum lands on a float32 tie in float64, below it exactly)."""
    from ccrs_tpu_torch.models.undistort import _fma

    rng = np.random.default_rng(3)
    n = 2000
    p = np.concatenate([[1 + 2.0**-18, -(1 + 2.0**-18)], rng.uniform(0, 255, n)])
    q = np.concatenate([[2.0**-24 * (1 - 2.0**-18)] * 2, rng.uniform(0, 1, n)])
    r = np.concatenate([[1 + 2.0**-23, -(1 + 2.0**-23)], rng.uniform(0, 255, n)])
    p, q, r = (a.astype(np.float32) for a in (p, q, r))
    got = _fma(*(torch.as_tensor(a) for a in (p, q, r))).numpy()
    want = np.array([
        _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
        for a, b, c in zip(p, q, r)
    ], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (p.astype(np.float64) * q + r).astype(np.float32)
    assert twice[0] != want[0] and twice[1] != want[1]


def test_undistortion_straightens_detected_rows():
    """Detected (distorted) corners, pushed through unproject and the
    estimated pinhole K, are collinear per board row; the remap pulls each
    output pixel from the mapped source pixel."""
    m = GenericModel(*EUCM)
    board, _, img = board_frame(m)
    tags = TagDetector("t36h11", device="cpu").detect(img)
    assert len(tags) >= 15
    K = estimate_new_camera_matrix_for_undistort(m, 0.5, (512, 512), device="cpu")

    def undistort_pts(pts):
        rays, valid = m.unproject(pts)
        assert valid.all()
        return rays[:, :2] / rays[:, 2:3] * K[0, 0] + K[:2, 2]

    worst = 0.0
    for row in range(6):
        row_tags = [t for t in sorted(tags) if row * 6 <= t < (row + 1) * 6]
        if len(row_tags) < 3:
            continue
        pts = undistort_pts(np.stack([tags[t][0] for t in row_tags]))
        A = np.stack([pts[:, 0], np.ones(len(pts))], 1)
        coef, *_ = np.linalg.lstsq(A, pts[:, 1], rcond=None)
        worst = max(worst, float(np.abs(A @ coef - pts[:, 1]).max()))
    assert worst < 0.6, f"rows not straight after undistortion: {worst:.2f}px"

    xmap, ymap = init_undistort_map(m, K, (512, 512), device="cpu")
    und = remap(img, xmap, ymap).numpy()
    assert und.shape == img.shape and und.dtype == img.dtype
    v, u = 250, 260
    x, y = float(xmap[v, u]), float(ymap[v, u])
    x0, y0 = int(x), int(y)
    fx, fy = x - x0, y - y0
    expected = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    assert abs(float(und[v, u]) - expected) <= 1.0
