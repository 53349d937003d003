"""CPU tests of what decides ``correct``, at a size a test run holds.

    python -m pytest benchmark/test_bench_correct.py -q

The control (the reference in float32 put in the program's place) must
come out as not correct under the configurations' limits, and a run whose
timed path is broken underneath must too, for each fault a cell can have:
a solve that returns its state unchanged, half of the frames left out of
the calibration, and an answer altered where it is produced (a misread
tag id, corners shifted by 0.3 px, 5% of the tags dropped, a calibrated
focal length nudged).  The cells run on one chip, so
there is no exchange between chips to leave out.  The runs here skip the
look for a card and drive the rest of ``run.measure`` on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cells  # noqa: E402


#: the cells of BENCHMARK.json at a size a test run holds (frames per recording)
CELLS = {"tumvi512-video": 96, "euroc-stereo-video": 48}


def small_cell(name: str):
    """A cell of BENCHMARK.json at the frames per recording of ``CELLS``."""
    cell = cells.find_cell(name)
    cell.config = dict(cell.config, frames_per_recording=CELLS[name])
    return cell


def run_cpu(cell, seed=2**31 + 21):
    import run

    torch.set_num_threads(4)
    args = types.SimpleNamespace(workload=cell.name, seed=seed, seconds=0.01, trace=0)
    return run.measure(cell, args, torch.device("cpu"))["line"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_and_detector_faults_are_not_correct(name):
    """The program passes every limit; its float32 control fails one, and so
    does each detector fault of ``control.FAULTS``."""
    import control

    torch.set_num_threads(4)
    (row,) = control.readings(small_cell(name), [2**31 + 3], torch.device("cpu"), fault_seeds=1)
    assert row["program_correct"], row["program"]
    assert not row["control_correct"], row["control"]
    assert set(row["faults"]) == set(control.FAULTS)
    for fault, got in row["faults"].items():
        assert not got["correct"], (fault, got["numbers"])


def test_sound_run_is_correct():
    line = run_cpu(small_cell("tumvi512-video"))
    assert line["correct"] is True, line["limits"]
    assert line["failed"] == 0


def _unchanged(orig):
    def solve(project_fn, theta0, poses0, *args, **kwargs):
        res = orig(project_fn, theta0, poses0, *args, **kwargs)
        return res._replace(theta=theta0.clone(), poses=poses0.clone())
    return solve


def _half_batch(orig):
    from ccrs_tpu_torch.calib.frames import FrameBatch

    def calib(board, batch, *args, **kwargs):
        mask = batch.mask.copy()
        mask[1::2] = False
        return orig(board, FrameBatch(batch.time_ns, batch.p2d, mask, batch.width,
                                      batch.height), *args, **kwargs)
    return calib


def _focal_nudged(orig):
    def calibrate(*args, **kwargs):
        model, rt = orig(*args, **kwargs)
        model = model.copy()
        p = model.params.copy()
        p[0] *= 1.0 + 1e-5
        model.set_params(p)
        return model, rt
    return calibrate


def _planted(fault):
    def wrap(orig):
        import control

        return control.faulty_detect(orig, fault, 5)
    return wrap


@pytest.mark.parametrize("fault,module,attr,number", [
    (_unchanged, "ccrs_tpu_torch.calib.single", "ba_solve", "intr_gap"),
    (_half_batch, "ccrs_tpu_torch.calib.pipeline", "calib_camera", "intr_gap"),
    (_focal_nudged, "harness.jobs", "calibrate_camera_with_retries", "intr_gap"),
    (_planted("corner_bias"), "harness.jobs", "Jobs._detect", "corner_bias_px"),
    (_planted("tags_dropped"), "harness.jobs", "Jobs._detect", "missed_share"),
])
def test_fault_is_not_correct(monkeypatch, fault, module, attr, number):
    """A run of the first cell with its timed path broken underneath."""
    owner = __import__(module, fromlist=["x"])
    *path, attr = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    line = run_cpu(small_cell("tumvi512-video"))
    assert line["correct"] is False, line["limits"]
    row = line["limits"][number]
    assert line["failed"] > 0 or row["value"] > row["limit"], line


def test_misread_tag_is_not_correct(monkeypatch):
    """A tag id altered where the detector produces it."""
    from ccrs_tpu_torch.detect import tracked

    orig = tracked.TrackedSession.finalize

    def finalize(self):
        out = orig(self)
        for det in out[::7]:
            if det:
                tag = next(iter(det))
                det[(int(tag) + 1) % 36] = det.pop(tag)
        return out

    monkeypatch.setattr(tracked.TrackedSession, "finalize", finalize)
    line = run_cpu(small_cell("tumvi512-video"))
    assert line["correct"] is False
    assert line["limits"]["wrong_tags"]["value"] > 0


def test_limits_are_set():
    """Every compared number has a finite limit, and the exact one is 0."""
    for name in ("tumvi-calib-cam1-512", "euroc-cam-april-stereo"):
        cfg = json.load(open(os.path.join(HERE, "configs", name + ".json")))
        for n, row in cfg["compared"].items():
            assert np.isfinite(row["limit"]) and row["limit"] >= 0, n
        assert cfg["compared"]["wrong_tags"]["limit"] == 0
