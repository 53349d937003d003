"""Dataset loaders of the PyTorch port against the JAX package.

A 16-frame one-camera EuRoC dataset written by the JAX package's
``write_euroc_dataset`` (PNGs through imageio) loads through both packages'
``load_euroc``, cold (``TagDetector(track=False)`` in both) and tracked
(both packages' default, streamed through a tracked session): timestamps
and masks exact, corners within 1e-3 px.  Also: ``start_idx``/``step``,
``load_general`` timestamps, a missing folder, ``.jpg`` input, and a
detection cache written by ``ccrs_tpu`` loading in the port.
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
from ccrs_tpu_torch.pngio import read_png

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
N_FRAMES = 16


def _cold():
    return TagDetector("t36h11", track=False)


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
    det = TagDetector("t36h11")
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
        str(dataset["root"] / "nope"), TagDetector("t36h11"), create_default_6x6_board()
    )[0]
    assert b.n_frames == 0 and b.p2d.shape == (0, 144, 2)


def test_reference_cache_loads_in_port(dataset, monkeypatch):
    """The JAX package's cache (same key, same .npz) is read by the port
    without detecting anything."""
    def no_detection(*a, **k):
        raise AssertionError("the port re-detected instead of reading the cache")

    monkeypatch.setattr(dl, "_detect_sequence", no_detection)
    b = dl.load_euroc(
        dataset["ds"], TagDetector("t36h11"), create_default_6x6_board(),
        cache_dir=dataset["cache"],
    )[0]
    ref = dataset["ref"]
    np.testing.assert_array_equal(b.time_ns, ref.time_ns)
    np.testing.assert_array_equal(b.mask, ref.mask)
    np.testing.assert_array_equal(b.p2d, ref.p2d)


def test_port_cache_roundtrip(dataset, tmp_path):
    cache = str(tmp_path / "c")
    det, board = TagDetector("t36h11"), create_default_6x6_board()
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
    b = dl.load_euroc(str(tmp_path / "j"), TagDetector("t36h11"), create_default_6x6_board())[0]
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

    det, board = TagDetector("t36h11"), create_default_6x6_board()
    rec = FakeRecorder(active=True)
    b = dl.load_euroc(dataset["ds"], det, board, step=4, recorder=rec)[0]
    assert [c[1] for c in rec.calls] == list(b.time_ns)
    for _, _, img, dets in rec.calls:
        assert img.shape == (512, 512) and len(dets) >= 6
    off = FakeRecorder(active=False)
    dl.load_euroc(dataset["ds"], det, board, step=4, recorder=off)
    assert off.calls == []
