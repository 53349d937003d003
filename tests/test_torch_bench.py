"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

- A small run of the whole program at 512x512, every path on (device
  frames, host images through the streaming session, the CLI on PNGs, the
  float64 re-solve gate): 96 frames, because the rendered sequence's
  first audit round falls at frame 91 (at 56 to 80 frames there is none,
  so no speculation is offered and the 512 gate on it fails).  Its
  JSON keys are ``bench.py``'s (read from its source) plus ``device``.
- No fallback: without a card and without ``--platform cpu`` both
  programs exit non-zero and print no result; a failing device render or
  device-resident detection raises instead of running on host images.
- No jax: both programs import, and their ``main`` runs, with ``jax`` and
  ``ccrs_tpu`` blocked, in a fresh process.

``bench_multicam_torch.py`` against ``bench_multicam.py``:
``tests/test_torch_bench_multicam.py``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_torch
from ccrs_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the fewest frames at which every gate of the 512 configuration holds
N_FRAMES_CPU = 96


def result_keys(path):
    """Keys a bench program can put in its JSON line: those of the dict
    literal assigned to ``out`` and every ``out[...]`` / ``extras[...]``
    assignment, read from the source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == "out" and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
            if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                    and target.value.id in ("out", "extras") and isinstance(target.slice, ast.Constant)):
                keys.add(target.slice.value)
    return keys


def test_sources_have_the_same_keys():
    want = result_keys(os.path.join(REPO, "bench.py"))
    assert {"value", "vs_baseline", "fps_host", "fps_cli", "fps_1024", "spec_offered"} <= want
    assert result_keys(os.path.join(REPO, "bench_torch.py")) == want | {"device"}


def test_small_run_every_path_passes_its_gates(monkeypatch):
    """``run(device="cpu")`` at 96 frames of 512x512 with the 1024
    configuration skipped (its code is run_config's again, without the
    stage-collecting paths)."""
    for knob in ("BENCH_HOST_IMAGES", "BENCH_NO_SPEC_ASSERT", "BENCH_SKIP_F64GATE",
                 "BENCH_SKIP_HOST", "BENCH_SKIP_CLI", "CCRS_TRACK", "CCRS_SPECULATE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("BENCH_SKIP_1024", "1")
    monkeypatch.setattr(bench_torch, "N_FRAMES", N_FRAMES_CPU)
    monkeypatch.setattr(profiling, "_ENABLED", profiling._ENABLED)  # run() turns timing on
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = bench_torch.run(device="cpu")
    finally:
        torch.set_num_threads(threads)
    json.dumps(out)
    skipped = {"fps_1024", "warmup_1024"}
    assert set(out) == (result_keys(os.path.join(REPO, "bench.py")) - skipped) | {"device"}
    assert out["device"] == "cpu"
    assert f"{N_FRAMES_CPU} frames" in out["metric"] and out["unit"] == "frames/sec"
    assert out["value"] > 0 and out["fps_host"] > 0 and out["fps_cli"] > 0
    assert out["vs_baseline"] == round(out["value"] / (534 / 2.0), 4)
    assert out["spec_offered"] is True
    assert out["stages_sec"] and all(v >= 0 for v in out["stages_sec"].values())


@pytest.mark.parametrize("broken", ["render", "detect"])
def test_device_failures_raise(monkeypatch, broken):
    """bench.py falls back to host images when the device render or the
    device-resident detection fails; the port raises."""

    def boom(*args, **kwargs):
        raise RuntimeError(f"{broken} failed")

    monkeypatch.setattr(bench_torch, "prewarm_calibration", lambda *a, **k: None)
    monkeypatch.setattr(bench_torch.TagDetector, "prewarm", lambda *a, **k: None)
    if broken == "render":
        monkeypatch.setattr(bench_torch, "render_frames_device", boom)
    else:
        monkeypatch.setattr(bench_torch.TagDetector, "detect_batch", boom)
    monkeypatch.delenv("BENCH_HOST_IMAGES", raising=False)
    with pytest.raises(RuntimeError, match=f"{broken} failed"):
        bench_torch.run_config(512, 2, False, device="cpu")


_SCRIPT = r"""
import contextlib, io, runpy, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ccrs_tpu"] = None
import torch
torch.cuda.is_available = lambda: False  # no card, whatever the machine has
program = sys.argv[1]
for argv, want in (([], "nonzero"), (["--help"], 0)):
    sys.argv = [program] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(program, run_name="__main__")
    except SystemExit as e:
        code = e.code
    else:
        raise AssertionError(f"{program} {argv} did not exit")
    if want == "nonzero":
        assert code not in (0, None), code
        assert out.getvalue() == "", out.getvalue()  # no result printed
    else:
        assert code == 0 and "--platform" in out.getvalue(), (code, out.getvalue())
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and (m == "ccrs_tpu" or m.startswith("ccrs_tpu.")))
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("program", ["bench_torch.py", "bench_multicam_torch.py"])
def test_programs_need_no_jax_and_no_card_means_no_result(program):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, os.path.join(REPO, program)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok", out.stdout
