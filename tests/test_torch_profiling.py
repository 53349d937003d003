"""Stage timers of the PyTorch port (``ccrs_tpu_torch.utils.profiling``):
``stage_prefix`` renames the stages of the calling thread only, so the
speculative calibration's thread reports ``spec/...`` beside the main
thread's stages, and ``spans()`` (CCRS_TIMING_SPANS=1) keeps one
(name, thread, t0, t1) record per stage run."""

import threading

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
