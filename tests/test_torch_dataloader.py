"""Dataset loaders of the PyTorch port against the JAX package.

A 16-frame one-camera EuRoC dataset written by the JAX package's
``write_euroc_dataset`` (PNGs through imageio) loads through both packages'
``load_euroc``, cold (``TagDetector(track=False)`` in both) and tracked
(both packages' default, streamed through a tracked session): timestamps
and masks exact, corners within 1e-3 px.  Also: ``start_idx``/``step``,
``load_general`` timestamps, a missing folder, ``.jpg`` input, and a
detection cache written by ``ccrs_tpu`` loading in the port.

Colour input: the same frames tinted and written as 8-bit RGB, 8-bit RGBA,
16-bit RGB and 8-bit palette PNGs load through both ``load_euroc``, tracked
and cold, with equal masks and corners within 1e-3 px (the JAX loader
reads through cv2 and ``cv2.cvtColor(BGR2GRAY)``; the port's integer luma
equals it, checked here on a random image and on all 2**24 colours where
cv2 imports, so the two detectors see the same pixels).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.dataloader import load_euroc as jax_load_euroc
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.testdata import write_euroc_dataset as jax_write_euroc
from ccrs_tpu_torch import dataloader as dl
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.detect import TagDetector
from ccrs_tpu_torch.pngio import read_png, write_png
from torch_jax_pin import fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
N_FRAMES = 16


def _cold():
    return TagDetector("t36h11", track=False, device="cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tdl")
    ds = str(root / "dataset")
    jax_write_euroc(ds, JaxModel("eucm", GT, 512, 512), n_frames=N_FRAMES, seed=5, noise=1.5)
    cache = str(root / "jax_cache")
    ref = jax_load_euroc(ds, JaxDetector("t36h11", track=False), jax_board(), cache_dir=cache)[0]
    port = dl.load_euroc(ds, _cold(), create_default_6x6_board())[0]
    return dict(root=root, ds=ds, cache=cache, ref=ref, port=port)


def test_load_euroc_matches_reference(dataset):
    ref, port = dataset["ref"], dataset["port"]
    assert port.n_frames == ref.n_frames == N_FRAMES
    np.testing.assert_array_equal(port.time_ns, ref.time_ns)
    np.testing.assert_array_equal(port.mask, ref.mask)
    m = ref.mask
    np.testing.assert_allclose(port.p2d[m], ref.p2d[m], rtol=0, atol=1e-3)
    assert (port.width, port.height) == (ref.width, ref.height) == (512, 512)
    assert port.frame_ok().sum() >= 0.8 * N_FRAMES


def test_tracked_load_matches_reference(dataset):
    """Both packages' default loaders (tracking on, chunks streamed into a
    tracked session) on the same PNGs: ids exact, corners within 1e-3 px."""
    ref = jax_load_euroc(dataset["ds"], JaxDetector("t36h11"), jax_board())[0]
    det = TagDetector("t36h11", device="cpu")
    assert det.track
    port = dl.load_euroc(dataset["ds"], det, create_default_6x6_board())[0]
    assert det.stats["frames"] == N_FRAMES and det.stats["waves"] > 0
    np.testing.assert_array_equal(port.time_ns, ref.time_ns)
    np.testing.assert_array_equal(port.mask, ref.mask)
    m = ref.mask
    np.testing.assert_allclose(port.p2d[m], ref.p2d[m], rtol=0, atol=1e-3)


def test_start_idx_and_step(dataset):
    full = dataset["port"]
    sub = dl.load_euroc(
        dataset["ds"], _cold(), create_default_6x6_board(),
        start_idx=1, step=3,
    )[0]
    np.testing.assert_array_equal(sub.time_ns, full.time_ns[1::3])
    np.testing.assert_array_equal(sub.mask, full.mask[1::3])
    m = sub.mask
    np.testing.assert_allclose(sub.p2d[m], full.p2d[1::3][m], rtol=0, atol=1e-3)


def test_load_general_timestamps(dataset, tmp_path):
    src = os.path.join(dataset["ds"], "mav0", "cam0", "data")
    dst = tmp_path / "gen" / "seq" / "cam0" / "imgs"
    dst.mkdir(parents=True)
    names = sorted(os.listdir(src))[:5]
    for i, n in enumerate(names):
        shutil.copy(os.path.join(src, n), dst / f"img_{i:03d}.png")
    b = dl.load_general(str(tmp_path / "gen"), _cold(), create_default_6x6_board())[0]
    assert list(b.time_ns) == [i * 100_000_000 for i in range(5)]
    np.testing.assert_array_equal(b.mask, dataset["port"].mask[:5])


def test_missing_folder_gives_empty_batch(dataset):
    b = dl.load_euroc(
        str(dataset["root"] / "nope"), TagDetector("t36h11", device="cpu"), create_default_6x6_board()
    )[0]
    assert b.n_frames == 0 and b.p2d.shape == (0, 144, 2)


def test_reference_cache_loads_in_port(dataset, monkeypatch):
    """The JAX package's cache (same key, same .npz) is read by the port
    without detecting anything."""
    def no_detection(*a, **k):
        raise AssertionError("the port re-detected instead of reading the cache")

    monkeypatch.setattr(dl, "_detect_sequence", no_detection)
    b = dl.load_euroc(
        dataset["ds"], TagDetector("t36h11", device="cpu"), create_default_6x6_board(),
        cache_dir=dataset["cache"],
    )[0]
    ref = dataset["ref"]
    np.testing.assert_array_equal(b.time_ns, ref.time_ns)
    np.testing.assert_array_equal(b.mask, ref.mask)
    np.testing.assert_array_equal(b.p2d, ref.p2d)


def test_port_cache_roundtrip(dataset, tmp_path):
    cache = str(tmp_path / "c")
    det, board = TagDetector("t36h11", device="cpu"), create_default_6x6_board()
    paths = dl._list_images(os.path.join(dataset["ds"], "mav0", "cam0", "data", "*"), 0, 4)
    b1 = dl.load_euroc(dataset["ds"], det, board, step=4, cache_dir=cache)[0]
    assert os.listdir(cache) == [os.path.basename(dl._cache_path(cache, 0, paths, det, board))]
    b2 = dl.load_euroc(dataset["ds"], det, board, step=4, cache_dir=cache)[0]
    np.testing.assert_array_equal(b1.p2d, b2.p2d)
    np.testing.assert_array_equal(b1.mask, b2.mask)


def test_jpg_input_and_missing_decoder(dataset, tmp_path, monkeypatch):
    import sys

    import imageio.v3 as iio

    src = sorted(os.listdir(os.path.join(dataset["ds"], "mav0", "cam0", "data")))[0]
    img = read_png(os.path.join(dataset["ds"], "mav0", "cam0", "data", src))
    d = tmp_path / "j" / "mav0" / "cam0" / "data"
    d.mkdir(parents=True)
    iio.imwrite(str(d / "10000000000.jpg"), img, quality=95)
    b = dl.load_euroc(str(tmp_path / "j"), TagDetector("t36h11", device="cpu"), create_default_6x6_board())[0]
    assert b.n_frames == 1 and b.time_ns[0] == 10_000_000_000
    assert b.mask[0].sum() >= 24

    for mod in ("cv2", "imageio", "imageio.v3", "PIL"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match="cv2.*imageio.*PIL"):
        dl._imread(str(d / "10000000000.jpg"))


def test_recorder_gets_every_frame(dataset):
    """An active recorder gets one call per frame, in timestamp order, with
    the image and its detections; an inactive one gets none."""

    class FakeRecorder:
        def __init__(self, active):
            self.active = active
            self.calls = []

        def log_camera_image(self, cam_idx, t_ns, img, dets):
            self.calls.append((cam_idx, t_ns, img, dets))

    det, board = TagDetector("t36h11", device="cpu"), create_default_6x6_board()
    rec = FakeRecorder(active=True)
    b = dl.load_euroc(dataset["ds"], det, board, step=4, recorder=rec)[0]
    assert [c[1] for c in rec.calls] == list(b.time_ns)
    for _, _, img, dets in rec.calls:
        assert img.shape == (512, 512) and len(dets) >= 6
    off = FakeRecorder(active=False)
    dl.load_euroc(dataset["ds"], det, board, step=4, recorder=off)
    assert off.calls == []


# ---- colour, 16-bit colour and palette datasets -------------------------

N_COLOUR = 8
TINT = np.array([0.93, 1.0, 0.62])  # R, G, B gains: a warm cast


def _chunk(t, p):
    import struct
    import zlib

    return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))


def _write_palette_png(path, idx, pal):
    """An 8-bit palette PNG (colour type 3) of ``idx`` through ``pal``."""
    import struct
    import zlib

    h, w = idx.shape
    raw = np.zeros((h, w + 1), np.uint8)
    raw[:, 1:] = idx
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)))
        f.write(_chunk(b"PLTE", pal.tobytes()))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_chunk(b"IEND", b""))


def _tinted(gray):
    """(H, W) uint8 -> (H, W, 3) uint8 with a colour cast and a little
    per-channel texture, so the luma lands between gray levels."""
    h, w = gray.shape
    wob = (np.add.outer(np.arange(h), np.arange(w)) % 3)[..., None] * np.array([1, 0, 2])
    return np.clip(gray[..., None] * TINT + wob, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module", params=["rgb8", "rgba8", "rgb16", "palette8"])
def colour_dataset(request, dataset, tmp_path_factory):
    layout = request.param
    src = os.path.join(dataset["ds"], "mav0", "cam0", "data")
    root = tmp_path_factory.mktemp("col_" + layout)
    dst = root / "mav0" / "cam0" / "data"
    dst.mkdir(parents=True)
    # a cooler cast than the RGB files': every index maps to its own colour
    k = np.arange(256)
    pal = np.stack([k * 0.85, np.minimum(k + 2, 255), k], axis=-1).astype(np.uint8)
    for name in sorted(os.listdir(src))[:N_COLOUR]:
        gray = read_png(os.path.join(src, name))
        rgb = _tinted(gray)
        if layout == "rgb8":
            write_png(str(dst / name), rgb)
        elif layout == "rgba8":
            alpha = np.full(gray.shape + (1,), 200, np.uint8)
            write_png(str(dst / name), np.concatenate([rgb, alpha], axis=-1))
        elif layout == "rgb16":
            write_png(str(dst / name), rgb.astype(np.uint16) * 257 + 101)
        else:
            _write_palette_png(str(dst / name), gray, pal)
    return str(root)


@pytest.mark.parametrize("track", [False, True], ids=["cold", "tracked"])
def test_colour_dataset_matches_reference(colour_dataset, track):
    """Tolerance 1e-3 px (the port's corner tolerance); the float luma the
    port used before was up to 2.7e-2 px away on such frames.

    16-bit colour: both detectors get the same float32 frames (uint16 luma
    / 257, checked against cv2 in ``test_imread_equals_cv2``), but those
    gray levels are fractional, so the float32 window sums of the corner
    refinement depend on their order, and one ill-conditioned corner of
    frame 0 (tag 22) moves 1.6e-2 to 2.4e-2 px under a 1-ulp change of the
    input within the port itself.  Held there: 99% of the corners within
    1e-3 px and every corner within 5e-2 px."""
    ref = jax_load_euroc(colour_dataset, JaxDetector("t36h11", track=track), jax_board())[0]
    port = dl.load_euroc(
        colour_dataset, TagDetector("t36h11", track=track, device="cpu"),
        create_default_6x6_board(),
    )[0]
    assert port.n_frames == ref.n_frames == N_COLOUR
    np.testing.assert_array_equal(port.mask, ref.mask)
    m = ref.mask
    assert m.sum() > 100 * N_COLOUR * 0.8
    if "rgb16" in os.path.basename(colour_dataset):  # the layout, not the tmp path
        err = np.abs(port.p2d[m] - ref.p2d[m]).max(axis=-1)
        assert np.quantile(err, 0.99) < 1e-3 and err.max() < 5e-2
    else:
        np.testing.assert_allclose(port.p2d[m], ref.p2d[m], rtol=0, atol=1e-3)


def test_imread_equals_cv2(colour_dataset):
    """The port's decoded gray plane is the JAX loader's, bit for bit."""
    pytest.importorskip("cv2")
    from ccrs_tpu.dataloader import _imread as jax_imread

    d = os.path.join(colour_dataset, "mav0", "cam0", "data")
    for n in sorted(os.listdir(d))[:3]:
        a, b = dl._imread(os.path.join(d, n)), jax_imread(os.path.join(d, n))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_colour_chunk_stays_uint8(colour_dataset):
    """8-bit colour and palette files upload as uint8 (the kernel's uint8
    path); 16-bit colour as float32 on the 0..255 scale."""
    d = os.path.join(colour_dataset, "mav0", "cam0", "data")
    imgs = [dl._imread(os.path.join(d, n)) for n in sorted(os.listdir(d))[:2]]
    up = dl._upload(imgs, torch.device("cpu"))
    assert up.shape == (2, 512, 512)
    if "rgb16" in os.path.basename(colour_dataset):  # the layout, not the tmp path
        assert imgs[0].dtype == np.uint16 and up.dtype == torch.float32
        assert float(up.max()) <= 255.0
    else:
        assert imgs[0].dtype == np.uint8 and up.dtype == torch.uint8


def test_gray_alpha_is_its_gray(tmp_path):
    g = np.random.default_rng(0).integers(0, 256, (6, 7, 2), dtype=np.uint8)
    write_png(str(tmp_path / "ga.png"), g)
    np.testing.assert_array_equal(dl._imread(str(tmp_path / "ga.png")), g[..., 0])


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_formula_equals_cv2_random(dtype):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, np.iinfo(dtype).max + 1, (256, 256, 3)).astype(dtype)
    want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
    got = dl._gray_like_cv2(rgb)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    rgba = np.concatenate([rgb, rgb[..., :1]], axis=-1)
    np.testing.assert_array_equal(dl._gray_like_cv2(rgba), want)


def test_gray_formula_equals_cv2_all_colours():
    """All 2**24 8-bit colours, one red plane (65,536 colours) at a time."""
    cv2 = pytest.importorskip("cv2")
    gb = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    rgb = np.empty((256, 256, 3), np.uint8)
    rgb[..., 1:] = gb
    for r in range(256):
        rgb[..., 0] = r
        want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
        assert np.array_equal(dl._gray_like_cv2(rgb), want), r


def test_jpg_fallbacks_give_cv2_gray(dataset, tmp_path, monkeypatch):
    """A colour .jpg read through imageio or PIL (cv2 blocked) becomes the
    uint8 gray that ``_gray_like_cv2`` gives for their RGB decode."""
    import sys

    import imageio.v3 as iio

    src = os.path.join(dataset["ds"], "mav0", "cam0", "data")
    gray = read_png(os.path.join(src, sorted(os.listdir(src))[0]))
    p = str(tmp_path / "c.jpg")
    iio.imwrite(p, _tinted(gray), quality=95)
    want = dl._gray_like_cv2(iio.imread(p))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got_iio = dl._imread(p)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    got_pil = dl._imread(p)
    for got in (got_iio, got_pil):
        assert got.dtype == np.uint8 and got.shape == gray.shape
        np.testing.assert_array_equal(got, want)
