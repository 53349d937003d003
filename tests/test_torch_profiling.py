"""Stage timers and counters of the PyTorch port
(``ccrs_tpu_torch.utils.profiling``): ``stage_prefix`` renames the stages
and counters of the calling thread only, so the speculative calibration's
thread reports ``spec/...`` beside the main thread's stages, and
``spans()`` (CCRS_TIMING_SPANS=1) keeps one (name, thread, t0, t1) record
per stage run.  With timing off nothing is recorded; a stage opens a
profiler range only inside a profiler session.  A tracked job opens each
layer's spans once per camera, and the benchmark's readers of spans and
counters read them."""

import collections
import importlib.util
import os
import threading
import types

import pytest
import torch

from ccrs_tpu_torch.utils import profiling


def test_stage_prefix_is_per_thread_and_spans_record_threads(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_SPANS", True)
    profiling.reset()
    inside = threading.Event()
    release = threading.Event()

    def spec_thread():
        with profiling.stage_prefix("spec/"):
            with profiling.stage("calib/ba"):
                inside.set()
                release.wait(timeout=30)

    t = threading.Thread(target=spec_thread, name="ccrs-spec")
    t.start()
    assert inside.wait(timeout=30)
    # the main thread's stage runs while the other thread holds its prefix
    with profiling.stage("calib/ba"):
        pass
    release.set()
    t.join(timeout=30)
    try:
        assert set(profiling.totals()) == {"calib/ba", "spec/calib/ba"}
        spans = {(name, thread) for name, thread, t0, t1 in profiling.spans() if t1 >= t0}
        assert spans == {
            ("calib/ba", threading.current_thread().name),
            ("spec/calib/ba", "ccrs-spec"),
        }
    finally:
        profiling.reset()
    assert profiling.totals() == {} and profiling.spans() == []


# ---- counters, profiler ranges, the layers' spans, the benchmark's readers

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")

#: the spans of the layers' host steps that a tracked detection and a
#: warm-started ladder open once per camera on the main thread (the warm
#: start picks no init frames there: the speculation thread does, and
#: ``detect/audit-plan`` opens twice per audit round)
ONCE_PER_CAMERA = ("detect/tracked", "detect/results", "calib/camera", "calib/spec-wait",
                   "calib/frames")


@pytest.fixture
def timing(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", True)
    monkeypatch.setattr(profiling, "_SPANS", True)
    profiling.reset()
    yield
    profiling.reset()


def _nested_in_own_name(spans) -> list:
    """Spans that lie inside an open span of the same name on their thread."""
    bad = []
    for name, thr, a, b in spans:
        if any(n == name and t == thr and (a2, b2) != (a, b) and a2 <= a and b <= b2
               for n, t, a2, b2 in spans):
            bad.append((name, thr))
    return bad


def test_timing_off_records_nothing_and_runs_bodies(monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", False)
    monkeypatch.setattr(profiling, "_SPANS", True)
    profiling.reset()
    ran = []
    with profiling.stage("calib/camera"):
        with profiling.stage_prefix("cam0/"):
            with profiling.stage("calib/ba"):
                ran.append(1)
            profiling.count("calib/cameras")
        ran.append(2)
    profiling.count("detect/frames", 7)
    assert ran == [1, 2]
    assert profiling.spans() == [] and profiling.counters() == {} and profiling.totals() == {}
    # an exception in a stage's body passes through, timing on or off
    for on in (False, True):
        monkeypatch.setattr(profiling, "_ENABLED", on)
        with pytest.raises(KeyError):
            with profiling.stage("calib/ba"):
                raise KeyError("body")
    assert set(profiling.totals()) == {"calib/ba"}
    profiling.reset()


def test_counters_take_the_thread_prefix_and_reset_clears_them(timing):
    profiling.count("detect/frames", 5)
    profiling.count("detect/frames")

    def spec_thread():
        with profiling.stage_prefix("spec/"):
            profiling.count("calib/cameras", 2)

    t = threading.Thread(target=spec_thread, name="ccrs-spec")
    t.start()
    t.join(timeout=30)
    with profiling.stage_prefix("cam1/"):
        profiling.count("calib/warm-used")
    assert profiling.counters() == {"detect/frames": 6, "spec/calib/cameras": 2,
                                    "cam1/calib/warm-used": 1}
    assert "ccrs counters:" in profiling.report()
    profiling.reset()
    assert profiling.counters() == {}


def test_profiler_ranges_only_inside_a_session(timing, monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def recording(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with profiling.stage("calib/camera"):
        pass
    assert opened == [], "a range was opened with no profiler session"
    profiling.reset()
    monkeypatch.setattr(profiling, "_ENABLED", False)

    def spec_thread():
        with profiling.stage_prefix("spec/"):
            with profiling.stage("calib/frames"):
                torch.ones(4).sum()

    with profiling.with_profiler(str(tmp_path)) as prof:
        assert profiling._ENABLED, "the session turns stage timing on"
        t = threading.Thread(target=spec_thread, name="ccrs-spec")
        t.start()
        t.join(timeout=30)
        with profiling.stage("detect/tracked"):
            torch.ones(4).sum()
    assert not profiling._ENABLED, "and off again after it"
    names = {e.name for e in prof.events()}
    assert {"detect/tracked", "spec/calib/frames"} <= names
    assert set(opened) == {"detect/tracked", "spec/calib/frames"}
    assert any(f.startswith("ccrs_trace_") for f in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def rendered():
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import get_family
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.testdata import render_frames_device, smooth_sequence_poses

    board = create_default_6x6_board()
    poses = smooth_sequence_poses(24, board, seed=3)
    imgs = render_frames_device(
        GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512), board,
        get_family("t36h11"), poses, noise=1.0, generator=torch.Generator().manual_seed(3),
        device="cpu")
    return board, imgs


def test_layer_spans_and_counters_on_a_tracked_job(timing, rendered):
    """Two cameras (the same frames) through a tracked session with a
    speculation and the ladder, then the joint solve: each new span once
    per camera, none inside one of its own name, the counters equal to the
    detector's and the ladder's own records."""
    from ccrs_tpu_torch.calib.frames import FrameBatch
    from ccrs_tpu_torch.calib.multi import (
        calib_all_camera_with_extrinsics,
        init_camera_extrinsic,
    )
    from ccrs_tpu_torch.calib.pipeline import SpeculativeCalib, calibrate_camera_with_retries
    from ccrs_tpu_torch.detect import TagDetector
    from ccrs_tpu_torch.models import zeros_like_model
    from ccrs_tpu_torch.types import CalibParams

    torch.set_num_threads(2)
    board, imgs = rendered
    times = list(range(len(imgs)))
    det = TagDetector("t36h11", device="cpu")
    cold, used, models, rtvecs, batches = 0, 0, [], [], []
    for cam in range(2):
        det.reset_tracking()
        gen = torch.Generator().manual_seed(7)
        spec = SpeculativeCalib(board, times, zeros_like_model("eucm"), CalibParams(), gen,
                                512, 512)
        det.on_provisional = spec.on_provisional
        session = det.begin_tracked(board, n_frames=len(imgs))
        for k in range(0, len(imgs), 8):
            session.feed(imgs[k:k + 8])
        dets = session.finalize()
        det.on_provisional = None
        assert det.stats["trigger_frames"] > 0, "the sequence must have an audit round"
        cold += det.stats["cold_frames"]
        batch = FrameBatch.from_detections(dets, times, board, 512, 512)
        model, rt = calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(), gen,
            warm_provider=spec.take, device="cpu")
        assert spec.error is None
        used += int(calibrate_camera_with_retries.last_spec_used)
        models.append(model)
        rtvecs.append(rt)
        batches.append(batch)
    t_i_0 = init_camera_extrinsic(rtvecs, device="cpu")
    assert calib_all_camera_with_extrinsics(
        board, models, t_i_0, rtvecs, batches, xy_same_focal=False, disabled_distortions=0,
        cam0_fixed_focal=False, device="cpu") is not None

    spans = profiling.spans()
    main = threading.current_thread().name
    opened = collections.Counter(n for n, thr, _, _ in spans if thr == main)
    for name in ONCE_PER_CAMERA:
        assert opened[name] == 2, (name, opened)
    assert opened["detect/audit-plan"] >= 2 * 2
    for name in ("joint/init-extrinsic", "joint/ba", "joint/assemble"):
        assert opened[name] == 1, (name, opened)
    spec_names = {n for n, thr, _, _ in spans if thr == "ccrs-spec"}
    assert {"spec/calib/frames", "spec/calib/pick-frames"} <= spec_names
    assert _nested_in_own_name(spans) == []
    c = profiling.counters()
    assert c["detect/frames"] == 2 * len(imgs)
    assert c["detect/cold-frames"] == cold
    assert c["calib/cameras"] == 2
    assert c["calib/warm-offered"] == 2
    assert c.get("calib/warm-used", 0) == used == 2


def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_benchmark_readers_of_spans_and_counters(timing, monkeypatch):
    jobs = [{"stages": {"detect/tracked": 0.5, "calib/camera": 0.1, "calib/spec-wait": 0.02,
                        "joint/init-extrinsic": 0.01, "joint/ba": 0.15}},
            {"stages": {"detect/tracked": 0.7, "calib/camera": 0.3, "calib/spec-wait": 0.0,
                        "joint/init-extrinsic": 0.03, "joint/ba": 0.05}}]
    gaps = [("detect/quadproc", 0.4), ("no stage open", 0.05), ("calib/camera", 0.01)]
    run = types.SimpleNamespace(per_job=jobs, trace={"window_s": 2.0, "idle_gaps": gaps})
    read = {n: _reader(n, monkeypatch) for n in (
        "detect_span_ms", "calibrate_span_ms", "joint_ba_span_ms", "spec_wait_ms",
        "spec_used_pct", "spec_offered_pct", "cold_frame_pct", "idle_no_stage_pct")}
    assert read["detect_span_ms"](run) == pytest.approx(600.0)
    assert read["calibrate_span_ms"](run) == pytest.approx(200.0)
    assert read["joint_ba_span_ms"](run) == pytest.approx(120.0)
    assert read["spec_wait_ms"](run) == pytest.approx(10.0)
    assert read["idle_no_stage_pct"](run) == pytest.approx(2.5)
    # label not listed: 0 when every gap is listed, else the smallest listed
    run.trace["idle_gaps"] = gaps[:1]
    assert read["idle_no_stage_pct"](run) == 0.0
    run.trace["idle_gaps"] = [(f"s{i}", 0.1 + i) for i in range(10)]
    assert read["idle_no_stage_pct"](run) == pytest.approx(5.0)
    # nothing to read: a program without the stages, a run without a trace
    bare = types.SimpleNamespace(per_job=[{"stages": {"detect/quadproc": 0.1}}], trace=None)
    for name in ("detect_span_ms", "calibrate_span_ms", "joint_ba_span_ms", "spec_wait_ms",
                 "idle_no_stage_pct", "spec_used_pct", "spec_offered_pct", "cold_frame_pct"):
        assert read[name](bare) is None, name
    profiling.count("calib/cameras", 4)
    profiling.count("calib/warm-offered", 4)
    profiling.count("calib/warm-used", 3)
    profiling.count("detect/frames", 200)
    profiling.count("detect/cold-frames", 30)
    assert read["spec_used_pct"](bare) == pytest.approx(75.0)
    assert read["spec_offered_pct"](bare) == pytest.approx(100.0)
    assert read["cold_frame_pct"](bare) == pytest.approx(15.0)
    monkeypatch.delattr(profiling, "counters")  # a program without counters
    for name in ("spec_used_pct", "spec_offered_pct", "cold_frame_pct"):
        assert read[name](bare) is None, name
