"""CPU tests of the benchmark's harness and yardstick.

    python -m pytest benchmark/test_bench_harness.py -q

Whole-job windows and their rates, the result line, the import rules, the
data-driven lookup of cells and metrics, and the generators against the
port's own ``testdata`` at a tiny size.  Tests that need the card carry
the ``cuda`` marker and decide inside the test whether one is present.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import cells, window  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_jobs(clock, durations):
    def job(k):
        clock.t += durations[k % len(durations)]
        return {"k": k}
    return job


def test_window_runs_whole_jobs_past_seconds():
    """A job that outlasts ``--seconds`` is run to its end and counted whole."""
    clock = FakeClock()
    done = window.run_window(fake_jobs(clock, [7.0]), seconds=5.0, clock=clock)
    assert len(done) == 1
    assert window.window_seconds(done) == pytest.approx(7.0)
    fps = cells.reader("fps")(types.SimpleNamespace(jobs=done, frames_per_job=534,
                                                     window_s=window.window_seconds(done)))
    assert fps == pytest.approx(534 / 7.0)


@pytest.mark.parametrize("durations,seconds,n", [([1.0], 3.0, 3), ([1.0], 3.5, 4),
                                                  ([2.0, 0.5], 4.0, 3), ([0.3, 2.9], 3.0, 2)])
def test_window_closes_on_a_job_boundary(durations, seconds, n):
    """Jobs start while less than ``seconds`` has passed; the window ends
    when the last started job ends, and the rate counts every job."""
    clock = FakeClock()
    done = window.run_window(fake_jobs(clock, durations), seconds=seconds, clock=clock)
    assert len(done) == n
    starts = [j.start for j in done]
    assert all(s - starts[0] < seconds for s in starts)
    assert done[-1].end - starts[0] >= seconds
    assert all(a.end == b.start for a, b in zip(done, done[1:]))
    total = sum(durations[k % len(durations)] for k in range(n))
    assert window.window_seconds(done) == pytest.approx(total)
    run = types.SimpleNamespace(jobs=done, window_s=window.window_seconds(done))
    assert cells.reader("calib_s")(run) == pytest.approx(total / n)


def test_window_counts_a_failed_job():
    clock = FakeClock()

    def job(k):
        clock.t += 1.0
        if k == 1:
            raise RuntimeError("boom")
        return k

    done = window.run_window(job, seconds=2.5, clock=clock)
    assert [j.error is None for j in done] == [True, False, True]
    assert "boom" in done[1].error


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*dirs):
    for d in dirs:
        for base, _, files in os.walk(os.path.join(HERE, d)):
            yield from (os.path.join(base, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("where,forbidden", [
    (("harness", "metrics"), {"jax", "jaxlib", "flax", "ccrs_tpu"}),
    (("gen", "reference"), {"jax", "jaxlib", "flax", "ccrs_tpu", "ccrs_tpu_torch"}),
])
def test_imports_by_whole_top_level_name(where, forbidden):
    """The harness may import the port (``ccrs_tpu_torch``) but never JAX or
    the JAX package; the generators and the reference import neither."""
    paths = list(_sources(*where))
    if "harness" in where:
        paths += [os.path.join(HERE, "run.py"), os.path.join(HERE, "control.py")]
    assert paths
    for p in paths:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & forbidden, (p, tops & forbidden)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "ccrs_tpu_torch_lookalike", types.ModuleType("x"))
    assert "ccrs_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ccrs_tpu.calib", types.ModuleType("ccrs_tpu.calib"))
    assert "ccrs_tpu" in run.forbidden_modules()


def test_the_port_loads_no_jax():
    """What the run imports, in a fresh process, holds no JAX module."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; import harness.jobs, "
            "harness.inputs, reference.check, control; print(run.forbidden_modules())"
            % (HERE, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "tumvi512-video", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_resolves():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "fps"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
        assert set(cell.config["compared"])


def _small(config_name, frames):
    cfg = json.load(open(os.path.join(HERE, "configs", config_name + ".json")))
    cfg["frames_per_recording"] = frames
    return cfg


def run_cpu(cell, seed=2**31 + 5, trace=0):
    """``run.measure`` on the CPU: the rest of a run without the look for a card."""
    import run

    torch.set_num_threads(4)
    args = types.SimpleNamespace(workload=cell.name, seed=seed, seconds=0.01, trace=trace)
    return run.measure(cell, args, torch.device("cpu"))["line"]


def test_new_cell_config_and_metric_need_only_new_files(tmp_path):
    """A configuration, a traffic mix and a metric dropped in as files, with
    new entries in a copy of BENCHMARK.json, run without an edit."""
    bdir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), bdir / sub)
    cfg = _small("euroc-cam-april-stereo", 120)
    cfg["name"] = "tiny-stereo"
    (bdir / "configs" / "tiny-stereo.json").write_text(json.dumps(cfg))
    (bdir / "traffic" / "stills-cached.json").write_text(json.dumps({
        "mode": "cached", "trajectory_seeds": [5], "rot_sigma": 0.3,
        "distance_m": [0.8, 1.4], "noise_px": 0.1, "visible_share": 0.9}))
    (bdir / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny.cached", "config": "tiny-stereo",
                               "traffic": "stills-cached", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "count", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.cached"]})
    cell = cells.find_cell("tiny.cached", bench, str(bdir))
    line = run_cpu(cell)
    assert line["metrics"]["jobs_done"]["value"] == line["attempted"] >= 1
    assert set(line["metrics"]) == {"jobs_done", "setup_s"}
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "limits"
    assert line["device"]["platform"] == "cpu"
    assert line["correct"] is True, line["limits"]
    for name, row in line["limits"].items():
        assert row["value"] <= row["limit"], name


def test_board_and_geometry_match_the_port():
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.models.projections import project_eucm, unproject_eucm
    from ccrs_tpu_torch.solve import se3
    from gen import camera
    from gen.board import Board

    assert np.array_equal(Board().p3d(), create_default_6x6_board().p3d)
    g = torch.Generator().manual_seed(3)
    rv = torch.randn(50, 3, generator=g, dtype=torch.float64)
    assert torch.allclose(camera.rotation(rv), se3.exp_so3(rv), atol=1e-14)
    params = torch.tensor([190.9, 190.87, 254.94, 256.86, 0.628, 1.046], dtype=torch.float64)
    pts = torch.randn(200, 3, generator=g, dtype=torch.float64) + torch.tensor([0, 0, 2.0])
    a, va = camera.project(params, pts)
    b, vb = project_eucm(params, pts)
    assert torch.equal(va, vb) and torch.allclose(a, b, atol=1e-10)
    pix = torch.rand(200, 2, generator=g, dtype=torch.float64) * 512
    a, va = camera.unproject(params, pix)
    b, vb = unproject_eucm(params, pix)
    assert torch.equal(va, vb) and torch.allclose(a, b, atol=1e-12)


def test_texture_and_poses_match_the_port():
    from scipy.spatial.transform import Rotation

    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import get_family
    from ccrs_tpu_torch.testdata import board_pattern_image, smooth_sequence_poses
    from gen import poses, render
    from gen.board import Board, t36h11

    tex, org, scale = render.board_texture(Board(), t36h11())
    tex2, org2, scale2 = board_pattern_image(create_default_6x6_board(), get_family("t36h11"))
    assert np.array_equal(tex, tex2) and np.allclose(org, org2) and scale == scale2
    mine = poses.trajectory(40, Board().p3d(), 11)
    theirs = smooth_sequence_poses(40, create_default_6x6_board(), seed=11)
    R1 = Rotation.from_rotvec(mine[:, :3]).as_matrix()
    R2 = Rotation.from_rotvec(theirs[:, :3]).as_matrix()
    assert np.allclose(R1, R2, atol=1e-12) and np.allclose(mine[:, 3:], theirs[:, 3:], atol=1e-12)


def test_render_matches_the_port():
    """Noise-free frames equal the port's renderer's, but for rounding of
    a few pixels at edges; the noise is the generator's Gaussian draw."""
    from ccrs_tpu_torch.board import create_default_6x6_board
    from ccrs_tpu_torch.detect import get_family
    from ccrs_tpu_torch.models import GenericModel
    from ccrs_tpu_torch.testdata import render_frames_device
    from gen import poses, render
    from gen.board import Board, t36h11

    params = [95.45, 95.435, 127.47, 128.43, 0.628, 1.046]
    p = poses.trajectory(6, Board().p3d(), 11)
    mine = render.render(params, 256, 256, Board(), t36h11(), p, torch.Generator(), 0.0)
    theirs = render_frames_device(GenericModel("eucm", params, 256, 256),
                                  create_default_6x6_board(), get_family("t36h11"), p,
                                  noise=0.0, device="cpu")
    diff = (mine.int() - theirs.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    noisy = render.render(params, 256, 256, Board(), t36h11(), p,
                          torch.Generator().manual_seed(1), 1.5)
    d = (noisy.float() - mine.float())
    assert abs(float(d.std()) - 1.5) < 0.1


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card, through the benchmark's command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "tumvi512-video", "--seed", str(2**31 + 11), "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
