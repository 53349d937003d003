"""The port's CLI default composition against the JAX package's, on the
CPU, with no detection cache: both CLIs track and speculate by default.

A 22-frame 512x512 EuRoC dataset rendered by the port goes through
``python -m ccrs_tpu_torch`` and ``python -m ccrs_tpu`` (each detecting
for itself).  The artifact sets and the report format are equal and
``cam0.json`` agrees within 1e-5 relative.  The port's default also
agrees with its own ``--no-speculate`` run within 1e-6 relative
(speculation changes timing, never results), and its cold composition
(``CCRS_TRACK=0 --no-speculate``) meets the same fx and median gates.
"""

import json

import numpy as np
import pytest
import torch

from ccrs_tpu.cli import main as jax_main
from ccrs_tpu_torch.calib.pipeline import calibrate_camera_with_retries
from ccrs_tpu_torch.cli import main
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import write_euroc_dataset

from test_torch_cli import GT, _in_dir, model_json, report_numbers

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_tracked")
    ds = str(root / "dataset")
    write_euroc_dataset(ds, GenericModel("eucm", GT, 512, 512), n_frames=22, seed=3, noise=1.5)
    base = [ds, "--no-rerun", "--model", "eucm", "--seed", "1"]
    out = {}
    for name, fn, extra, env in (
        ("port", main, ["--platform", "cpu"], {}),
        ("port_nospec", main, ["--platform", "cpu", "--no-speculate"], {}),
        ("port_cold", main, ["--platform", "cpu", "--no-speculate"], {"CCRS_TRACK": "0"}),
        ("jax", jax_main, [], {}),
    ):
        with _in_dir(root / name, env) as log:
            fn(base + extra + ["-o", str(root / name / "out")])
        out[name] = (root / name / "out", log.getvalue())
        if fn is main:
            out[name + "_spec_used"] = calibrate_camera_with_retries.last_spec_used
    return out


def _params(out):
    tag, p = model_json(out / "cam0.json")
    assert tag == "EUCM"
    return np.array(list(p.values()))


def test_default_matches_jax_default(runs):
    port, jax = runs["port"][0], runs["jax"][0]
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jax.iterdir())
    fmt_p, nums_p = report_numbers(port / "report.txt")
    fmt_j, nums_j = report_numbers(jax / "report.txt")
    assert fmt_p == fmt_j
    np.testing.assert_allclose(_params(port), _params(jax), rtol=1e-5)
    assert abs(_params(port)[0] - GT[0]) / GT[0] < 0.01 and nums_p[1] < 0.3
    poses_p = json.loads((port / "cam0_poses.json").read_text())
    poses_j = json.loads((jax / "cam0_poses.json").read_text())
    assert list(poses_p) == list(poses_j)


def test_speculation_changes_no_result(runs):
    assert runs["port_spec_used"] and not runs["port_nospec_spec_used"]
    np.testing.assert_allclose(
        _params(runs["port"][0]), _params(runs["port_nospec"][0]), rtol=1e-6
    )


def test_cold_composition_meets_the_gates(runs):
    out = runs["port_cold"][0]
    p = _params(out)
    _, nums = report_numbers(out / "report.txt")
    assert abs(p[0] - GT[0]) / GT[0] < 0.01 and nums[1] < 0.3
    np.testing.assert_allclose(p, _params(runs["port"][0]), rtol=1e-3)
