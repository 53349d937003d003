"""The port's process warm-up on the CPU: it changes timing, never results.

- ``TagDetector.prewarm`` runs tracked and cold, with and without a board,
  and leaves the detector as it found it: ``stats``, ``debug``, the hook,
  the tracking carry, the global random state, and the detections that
  follow (bit for bit those of a detector that never warmed up).
- ``prewarm_calibration`` runs one init attempt and one ``calib_camera``
  per variant of the JAX function (the cold final solve; with
  ``speculative`` the warm-path final and the float32-PnP seed solve), for
  every model and both solvers, on dummy problems of ``WARM_FRAMES`` frames,
  and touches no generator but its own.
- The loaders call ``prewarm_cb`` once, for camera 0 only, on a daemon
  thread, with the arguments the JAX loader gives its callback on the same
  files; the CLI's callback hands ``TagDetector.prewarm`` and
  ``prewarm_calibration`` the arguments of ``ccrs_tpu/cli.py:140-178``.
- ``cli.main`` writes the same bytes with ``CCRS_PREWARM=1`` and ``0``
  (artifacts and cached detections), and a warm-up that raises is recorded
  and does not end the run.
"""

import contextlib
import io
import os
import threading

import numpy as np
import pytest
import torch

import ccrs_tpu.dataloader as jax_loader
from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu_torch import cli
from ccrs_tpu_torch import dataloader as port_loader
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib import prewarm as port_prewarm
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.models import MODEL_NAMES, GenericModel
from ccrs_tpu_torch.testdata import (
    render_frames_device,
    smooth_sequence_poses,
    write_euroc_dataset,
)
from ccrs_tpu_torch.types import CalibParams

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


@pytest.fixture(scope="module")
def frames():
    board = create_default_6x6_board()
    model = GenericModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(10, board, seed=4)
    imgs = render_frames_device(
        model, board, get_family("t36h11"), poses, noise=1.5,
        generator=torch.Generator().manual_seed(4), device="cpu",
    )
    return board, imgs


def _equal_detections(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for t in da:
            np.testing.assert_array_equal(da[t], db[t])


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("with_board", [True, False])
def test_detector_prewarm_leaves_results_and_state(frames, track, with_board):
    board, imgs = frames
    plain = TagDetector(device="cpu", track=track)
    want = plain.detect_batch(None, board=board, dev_images=imgs[:6])
    want2 = plain.detect_batch(None, board=board, dev_images=imgs[6:])

    det = TagDetector(device="cpu", track=track)
    hook = det.on_provisional = lambda results: None
    rng_state, np_state = torch.get_rng_state(), np.random.get_state()[1].copy()
    det.prewarm(512, 512, board if with_board else None, n_frames=10)
    assert det.stats == {} and det.debug is None and det._tstate is None
    assert det.prewarm_launches == 0  # the plain version ran: no card here
    got = det.detect_batch(None, board=board, dev_images=imgs[:6])
    # between two batches: the carry, the stats and the hook stay
    stats, tstate = dict(det.stats), det._tstate
    det.prewarm(512, 512, board if with_board else None)
    assert det.stats == stats and det._tstate is tstate and det.on_provisional is hook
    got2 = det.detect_batch(None, board=board, dev_images=imgs[6:])
    _equal_detections(got, want)
    _equal_detections(got2, want2)
    assert det.stats == plain.stats
    assert torch.equal(torch.get_rng_state(), rng_state)
    np.testing.assert_array_equal(np.random.get_state()[1], np_state)
    assert sum(len(d) for d in got) > 100  # real detections, not empty frames


def test_detector_prewarm_takes_the_pyramid_scale_and_small_frames():
    det = TagDetector(device="cpu")
    board = create_default_6x6_board()
    det.prewarm(768, 1024, board, n_frames=3)  # scale 2
    det.prewarm(100, 60, board)  # narrower than one square row


@pytest.mark.parametrize("solver", ["f64", "mixed"])
@pytest.mark.parametrize("speculative", [False, True])
def test_prewarm_calibration_variants(monkeypatch, speculative, solver):
    board = create_default_6x6_board()
    calls = []
    real_calib, real_init = port_prewarm.calib_camera, port_prewarm.try_init_camera

    def calib(board_, batch, camera, one_focal, disabled, fixed, **kw):
        calls.append(("calib", batch.n_frames, kw["polish_iters"], kw["skip_pose_init"],
                      kw["pose_init_f32"], kw["solver"], kw["device"], one_focal, disabled))
        res = real_calib(board_, batch, camera, one_focal, disabled, fixed, **kw)
        assert res is not None and np.isfinite(res[0].params).all()
        return res

    def init(board_, batch, f0, f1, generator, fixed_focal, **kw):
        calls.append(("init", batch.n_frames, f0, f1, fixed_focal, kw["solver"]))
        return real_init(board_, batch, f0, f1, generator, fixed_focal, **kw)

    monkeypatch.setattr(port_prewarm, "calib_camera", calib)
    monkeypatch.setattr(port_prewarm, "try_init_camera", init)
    mine = torch.Generator().manual_seed(5)
    mine_state, rng_state = mine.get_state(), torch.get_rng_state()
    np_state = np.random.get_state()[1].copy()
    port_prewarm.prewarm_calibration(
        board, 300, "eucm", CalibParams(one_focal=True, disabled_distortion_num=1),
        752, 480, speculative=speculative, n_frames_spec=640, device="cpu", solver=solver,
    )
    F = port_prewarm.WARM_FRAMES
    want = [("init", F, 0, 1, None, solver),
            ("calib", F, 12, False, False, solver, "cpu", True, 1)]
    if speculative:  # ccrs_tpu/calib/prewarm.py:137-142
        want += [("calib", F, 12, True, False, solver, "cpu", True, 1),
                 ("calib", F, 2, False, True, solver, "cpu", True, 1)]
    assert calls == want
    assert torch.equal(mine.get_state(), mine_state)
    assert torch.equal(torch.get_rng_state(), rng_state)
    np.testing.assert_array_equal(np.random.get_state()[1], np_state)


@pytest.mark.parametrize("name", list(MODEL_NAMES))
def test_prewarm_calibration_every_model(name):
    """Every model warms from its zeros model, a string or a model with
    parameters; fewer real frames than WARM_FRAMES shrink the dummy."""
    board = create_default_6x6_board()
    port_prewarm.prewarm_calibration(board, 3, name, device="cpu")
    assert port_prewarm._dummy_batch(
        board, port_prewarm._plausible(port_prewarm.zeros_like_model(name), 512, 512), 3
    )[0].n_frames == 3
    if name == "eucm":
        port_prewarm.prewarm_calibration(
            board, 50, GenericModel("eucm", GT, 512, 512),
            CalibParams(fixed_focal=190.0), speculative=True, device="cpu",
        )


class StubDetector:
    """What a loader needs of a detector, detecting nothing."""

    device = torch.device("cpu")
    family = type("F", (), {"name": "t36h11"})()
    on_provisional = None

    def reset_tracking(self):
        pass

    def begin_tracked(self, board, n_frames=None):
        return None

    def detect_batch(self, images, board=None, dev_images=None):
        return [dict() for _ in range(dev_images.shape[0])]


@pytest.fixture(scope="module")
def stereo_ds(tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("prewarm") / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 320, 256), n_frames=5, cam_num=2,
                        seed=2, noise=1.0, device="cpu")
    # a general-layout copy of cam1 with one frame fewer than cam0
    os.remove(sorted(
        os.path.join(ds, "mav0", "cam1", "data", f)
        for f in os.listdir(os.path.join(ds, "mav0", "cam1", "data"))
    )[-1])
    return ds


@pytest.mark.parametrize("loader", ["load_euroc", "load_general"])
def test_prewarm_cb_once_for_camera_0_as_the_jax_loader(stereo_ds, loader):
    def run(module, board):
        seen, done = [], threading.Event()

        def cb(width, height, n_frames):
            t = threading.current_thread()
            seen.append((width, height, n_frames, t.daemon, t is threading.main_thread()))
            done.set()

        getattr(module, loader)(stereo_ds, StubDetector(), board, cam_num=2, prewarm_cb=cb)
        assert done.wait(10)
        return seen

    got = run(port_loader, create_default_6x6_board())
    want = run(jax_loader, jax_board())
    assert got == want == [(320, 256, 5, True, False)]
    # no callback, no thread; the argument is optional
    getattr(port_loader, loader)(stereo_ds, StubDetector(), create_default_6x6_board())


def _args(**kw):
    ns = cli.build_parser().parse_args(["x", "--model", "eucm"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("n_frames,n_detect", [(100, 100), (192, 192), (700, 768)])
def test_cli_callback_arguments(monkeypatch, n_frames, n_detect):
    """ccrs_tpu/cli.py:140-178: the detector warms at the padded sequence
    length, the calibration at min(n_frames, --max-images) with the
    camera-0 parameters, ``speculative`` as the run speculates and the
    speculation's frame count."""
    calls = {}

    class Det:
        def prewarm(self, height, width, board, n_frames=None):
            calls["detect"] = (height, width, board, n_frames)

    monkeypatch.setattr(
        cli, "prewarm_calibration", lambda *a, **k: calls.__setitem__("calib", (a, k))
    )
    monkeypatch.setenv("CCRS_PREWARM", "1")
    args = _args(max_images=600, fixed_focal=300.0, one_focal=True)
    board = object()
    pw = cli.Prewarm(args, Det(), board, torch.device("cpu"), speculative=True)
    pw(752, 480, n_frames)
    assert calls["detect"] == (480, 752, board, n_detect)
    a, k = calls["calib"]
    assert a[:2] == (board, min(n_frames, 600)) and a[2] == "eucm"
    assert a[3] == CalibParams(fixed_focal=300.0, disabled_distortion_num=0, one_focal=True)
    assert a[4:] == (752, 480)
    assert k == dict(speculative=True, n_frames_spec=n_frames, device=torch.device("cpu"))
    assert pw.error is None and pw.seconds is not None
    pw.join()  # called on its own thread here: nothing to wait for

    # off when asked, and off by default: the warm-up is opt-in
    calls.clear()
    for value in ("0", None):
        if value is None:
            monkeypatch.delenv("CCRS_PREWARM")
        else:
            monkeypatch.setenv("CCRS_PREWARM", value)
        off = cli.Prewarm(args, Det(), board, torch.device("cpu"), speculative=False)
        off(752, 480, n_frames)
        assert calls == {} and off.seconds is None and off.error is None


@contextlib.contextmanager
def _run_dir(path, env):
    old_cwd, old_env = os.getcwd(), dict(os.environ)
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            yield out
    finally:
        os.chdir(old_cwd)
        os.environ.clear()
        os.environ.update(old_env)


@pytest.fixture(scope="module")
def mono_ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("prewarm_cli")
    ds = str(root / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 512, 512), n_frames=14, seed=3,
                        noise=1.5, device="cpu")
    return root, ds


def _cli(root, ds, name, env, extra=()):
    out = root / name
    with _run_dir(out, env) as log:
        cli.main([ds, "--platform", "cpu", "--no-rerun", "--model", "eucm", "--seed", "1",
                  "--detection-cache", str(out / "cache"), "-o", str(out / "out"), *extra])
    return out, log.getvalue()


def _files(folder):
    return {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("extra", [(), ("--no-speculate",)], ids=["speculative", "cold"])
def test_cli_same_bytes_with_and_without_prewarm(mono_ds, extra):
    root, ds = mono_ds
    tag = "spec" if not extra else "cold"
    on, log_on = _cli(root, ds, f"on_{tag}", {"CCRS_PREWARM": "1"}, extra)
    assert cli.main.last_prewarm.error is None and cli.main.last_prewarm.seconds > 0
    assert "prewarm took" in log_on and "prewarm error" not in log_on
    off, log_off = _cli(root, ds, f"off_{tag}", {"CCRS_PREWARM": "0"}, extra)
    assert cli.main.last_prewarm.seconds is None and "prewarm took" not in log_off
    a, b = _files(on / "out"), _files(off / "out")
    assert sorted(a) == sorted(b) and {"cam0.json", "extrinsics.json", "report.txt"} <= set(a)
    assert a == b
    # the detections themselves: the cached arrays
    (ca,), (cb,) = (list((d / "cache").iterdir()) for d in (on, off))
    with np.load(ca) as za, np.load(cb) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


def test_cli_survives_a_failing_prewarm(mono_ds, monkeypatch):
    root, ds = mono_ds

    def boom(*a, **k):
        raise RuntimeError("warm-up fault for the test")

    monkeypatch.setattr(cli, "prewarm_calibration", boom)
    out, log = _cli(root, ds, "boom", {"CCRS_PREWARM": "1"})
    assert "warm-up fault for the test" in cli.main.last_prewarm.error
    assert "prewarm error: RuntimeError" in log and "results written to" in log
    ref, _ = _cli(root, ds, "boom_ref", {"CCRS_PREWARM": "0"})
    assert _files(out / "out") == _files(ref / "out")
