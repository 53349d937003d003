"""The port's example scripts, run as ``python -m
ccrs_tpu_torch.examples.<name> --platform cpu`` in a subprocess: model
conversion + undistortion of a given PNG, and detect -> PnP -> undistortion
of a rendered frame.  Their output files are checked; without a card the
default ``--platform cuda`` exits non-zero."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ccrs_tpu_torch.models import GenericModel, model_from_json, model_to_json
from ccrs_tpu_torch.pngio import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUCM = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def run(name, args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run(
        [sys.executable, "-m", f"ccrs_tpu_torch.examples.{name}"] + args,
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300,
    )


def test_convert_model_example(tmp_path):
    model_to_json(str(tmp_path / "eucm.json"), GenericModel("eucm", EUCM, 512, 512))
    rng = np.random.default_rng(0)
    write_png(str(tmp_path / "frame.png"), rng.integers(0, 256, (512, 512), np.uint8))
    out = run("convert_model", ["eucm.json", "frame.png", "--platform", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr
    ucm = model_from_json(str(tmp_path / "ucm.json"))
    assert ucm.name == "ucm" and (ucm.width, ucm.height) == (512, 512)
    # the grid fit keeps the principal point and lands near the focal
    np.testing.assert_allclose(ucm.params[2:4], EUCM[2:4], atol=0.1)
    assert abs(ucm.params[0] / EUCM[0] - 1) < 0.01
    img = read_png(str(tmp_path / "remaped_ucm.png"))
    assert img.shape == (1024, 1024) and img.dtype == np.uint8
    assert 0.5 < (img > 0).mean() <= 1.0  # the wide view keeps most pixels
    assert "wrote remaped_ucm.png" in out.stdout


def test_pnp_example(tmp_path):
    out = run("test_pnp", ["--platform", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_tags = int(next(ln for ln in lines if ln.startswith("detected")).split()[1])
    assert n_tags >= 4
    err = next(ln for ln in lines if ln.startswith("reprojection err"))
    assert float(err.split("max")[1].split("px")[0]) < 1.0, err
    img = read_png(str(tmp_path / "remaped_euroc.png"))
    assert img.shape == (1024, 1024) and img.dtype == np.uint8 and img.max() > 0


@pytest.mark.parametrize("name,args", [("convert_model", ["x.json"]), ("test_pnp", [])])
def test_examples_default_to_the_card(tmp_path, name, args):
    """Without a card the default platform exits non-zero; it never falls
    back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default platform runs")
    out = run(name, args, tmp_path)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
