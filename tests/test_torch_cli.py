"""The port's CLI (``python -m ccrs_tpu_torch``) end to end on the CPU,
against the JAX package's cold CLI composition.

A 22-frame 512x512 EuRoC dataset rendered by the port goes through the
port's CLI (``--platform cpu``), which also writes its detection cache.
``ccrs_tpu``'s CLI then runs cold (``CCRS_TRACK=0 CCRS_SPECULATE=0
--no-speculate``) on the same detections by reading that cache.  The
artifact sets and the report format are equal, ``cam0.json`` agrees within
1e-5 relative, fx is within 1% of the ground truth and the median
reprojection error below 0.3 px.  Every ``--model`` runs through the port's
CLI, with the camchain text equal to the JAX package's ``write_camchain``
of the same models; a bad path and ``--platform cuda`` without a card exit.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccrs_tpu.cli import main as jax_main
from ccrs_tpu_torch.cli import main
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import write_euroc_dataset
from torch_jax_pin import fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _in_dir(path, env=None):
    """Run with ``path`` as the working directory (default_board_config.json
    lands there) and ``env`` set, quietly."""
    old_cwd, old_env = os.getcwd(), dict(os.environ)
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            yield out
    finally:
        os.chdir(old_cwd)
        os.environ.clear()
        os.environ.update(old_env)


def run_both(root, ds, extra):
    """Port CLI, then the JAX CLI cold on the port's cached detections.
    Returns the two working directories and the port's printed lines."""
    cache = str(root / "cache")
    with _in_dir(root / "port") as log:
        main([ds, "--platform", "cpu", "--no-rerun", "--detection-cache", cache,
              "-o", str(root / "port" / "out")] + extra)
    with _in_dir(root / "jax", {"CCRS_TRACK": "0", "CCRS_SPECULATE": "0"}):
        jax_main([ds, "--no-rerun", "--no-speculate", "--detection-cache", cache,
                  "-o", str(root / "jax" / "out")] + extra)
    return root / "port", root / "jax", log.getvalue()


def model_json(path):
    blob = json.loads(path.read_text())
    (tag, inner), = blob.items()
    return tag, inner


def report_numbers(path):
    text = path.read_text()
    return re.sub(r"\d+\.\d+", "X", text), [float(v) for v in re.findall(r"\d+\.\d+", text)]


def check_against_reference(port, jax, cam_num):
    """The assertions shared by the mono and stereo runs."""
    assert sorted(os.listdir(port / "out")) == sorted(os.listdir(jax / "out"))
    assert (port / "default_board_config.json").read_text() == (
        jax / "default_board_config.json"
    ).read_text()
    fmt_p, nums_p = report_numbers(port / "out" / "report.txt")
    fmt_j, nums_j = report_numbers(jax / "out" / "report.txt")
    assert fmt_p == fmt_j and fmt_p.startswith("Calibrate with extrinsics: true")
    np.testing.assert_allclose(nums_p, nums_j, rtol=0, atol=2e-5)  # 5 decimals
    assert all(n < 0.3 for n in nums_p[1::2]), nums_p  # medians
    for c in range(cam_num):
        tag_p, p = model_json(port / "out" / f"cam{c}.json")
        tag_j, j = model_json(jax / "out" / f"cam{c}.json")
        assert tag_p == tag_j == "EUCM" and list(p) == list(j)
        np.testing.assert_allclose(list(p.values()), list(j.values()), rtol=1e-5)
        assert abs(p["fx"] - GT[0]) / GT[0] < 0.01, p
        poses_p = json.loads((port / "out" / f"cam{c}_poses.json").read_text())
        poses_j = json.loads((jax / "out" / f"cam{c}_poses.json").read_text())
        assert list(poses_p) == list(poses_j)
    ext_p = json.loads((port / "out" / "extrinsics.json").read_text())["rtvecs"]
    ext_j = json.loads((jax / "out" / "extrinsics.json").read_text())["rtvecs"]
    assert len(ext_p) == len(ext_j) == cam_num
    for a, b in zip(ext_p, ext_j):
        np.testing.assert_allclose(a["rvec"], b["rvec"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a["tvec"], b["tvec"], rtol=0, atol=1e-6)
    return ext_p


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ds = str(root / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 512, 512), n_frames=22, seed=3, noise=1.5, device="cpu")
    port, jax, log = run_both(root, ds, ["--model", "eucm", "--seed", "1"])
    return dict(root=root, ds=ds, port=port, jax=jax, log=log)


def test_cli_mono_matches_reference(mono):
    check_against_reference(mono["port"], mono["jax"], 1)
    assert "device: cpu" in mono["log"] and "results written to" in mono["log"]
    poses = json.loads((mono["port"] / "out" / "cam0_poses.json").read_text())
    assert len(poses) >= 15 and set(next(iter(poses.values()))) == {"rvec", "tvec"}


@pytest.mark.parametrize("name", ["ucm", "eucm", "eucmt", "kb4", "opencv5", "ftheta"])
def test_cli_every_model_and_camchain(mono, name, tmp_path):
    """Every model runs through the port's CLI (on the cached detections);
    the camchain text equals the JAX package's write_camchain of the same
    models, and the models without a Kalibr counterpart skip it."""
    from ccrs_tpu.export import write_camchain as jax_write_camchain
    from ccrs_tpu.models import model_from_json as jax_model_from_json
    from ccrs_tpu.types import RvecTvec as JaxRvecTvec

    out = tmp_path / "out"
    with _in_dir(tmp_path) as log:
        main([mono["ds"], "--platform", "cpu", "--no-rerun", "--model", name,
              "--seed", "1", "--export-camchain", "--detection-cache",
              str(mono["root"] / "cache"), "-o", str(out)])
    model = GenericModel.from_json(json.loads((out / "cam0.json").read_text()))
    assert model.name == name and np.isfinite(model.params).all()
    _, nums = report_numbers(out / "report.txt")
    assert np.isfinite(nums).all()
    if name in ("ucm", "eucm", "eucmt", "kb4", "ftheta"):
        assert nums[1] < 0.3, nums  # the fisheye models fit the EUCM camera
    if name in ("eucmt", "ftheta"):
        assert not (out / "camchain.yaml").exists()
        assert "camchain export skipped" in log.getvalue()
        return
    ext = json.loads((out / "extrinsics.json").read_text())["rtvecs"]
    jax_write_camchain(
        str(tmp_path / "ref.yaml"), [jax_model_from_json(str(out / "cam0.json"))],
        [JaxRvecTvec.from_json(e) for e in ext],
    )
    assert (out / "camchain.yaml").read_text() == (tmp_path / "ref.yaml").read_text()


def test_cli_profile_dir_writes_a_trace(mono, tmp_path):
    """CCRS_PROFILE_DIR wraps the run in a torch.profiler trace."""
    trace_dir = tmp_path / "trace"
    with _in_dir(tmp_path, {"CCRS_PROFILE_DIR": str(trace_dir)}):
        main([mono["ds"], "--platform", "cpu", "--no-rerun", "--step", "4",
              "--detection-cache", str(mono["root"] / "cache"), "-o", "out"])
    (trace,) = trace_dir.glob("ccrs_trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def test_cli_bad_path(tmp_path):
    with _in_dir(tmp_path), pytest.raises(SystemExit):
        main([str(tmp_path / "nope"), "--no-rerun", "--platform", "cpu"])


def test_cli_platform_cuda_without_card_exits(mono, tmp_path):
    """--platform cuda never runs on the CPU: without a card it exits
    non-zero before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less exit")
    out = tmp_path / "out"
    with _in_dir(tmp_path), pytest.raises(SystemExit) as e:
        main([mono["ds"], "--no-rerun", "--platform", "cuda", "-o", str(out)])
    assert e.value.code not in (0, None)
    assert not out.exists() and not (tmp_path / "default_board_config.json").exists()


_NO_JAX = r"""
import runpy, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.argv = ["ccrs"] + sys.argv[1:]
runpy.run_module("ccrs_tpu_torch", run_name="__main__")
bad = sorted(m for m in sys.modules if m == "ccrs_tpu" or m.startswith("ccrs_tpu."))
assert not bad, bad
"""


def test_cli_runs_without_jax(mono, tmp_path):
    """``python -m ccrs_tpu_torch <ds> --model eucm --platform cpu`` in a
    process where ``import jax`` fails writes the full artifact set."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, mono["ds"], "--model", "eucm",
         "--platform", "cpu", "--no-rerun", "--step", "2", "-o", "out"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path / "out")) == [
        "cam0.json", "cam0_poses.json", "extrinsics.json", "report.txt",
    ]
    assert (tmp_path / "default_board_config.json").exists()
    assert "results written to out" in proc.stdout
