"""The port runs on the card unless the caller asks for the CPU.

Every public entry point defaults to the current CUDA device, and the
CLI's and the renderer's ``--platform`` default, like ``auto``, exits
without a card instead of running on the CPU.  Only ``cpu`` runs there.
"""

import inspect
import os
import subprocess
import sys

import pytest
import torch

from ccrs_tpu_torch import cli, testdata
from ccrs_tpu_torch.calib import convert, initialize, multi, pipeline, single
from ccrs_tpu_torch.detect import TagDetector, ccl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENTRY_POINTS = [
    pipeline.init_and_calibrate_one_camera,
    pipeline.calibrate_camera_with_retries,
    single.calib_camera,
    initialize.try_init_camera,
    convert.conversion_grid,
    convert.convert_model,
    multi.init_camera_extrinsic,
    multi.calib_all_camera_with_extrinsics,
    testdata.render_frames_device,
    testdata.write_euroc_dataset,
    cli.save_and_validate_results,
    ccl.label_components,
    ccl.extract_quads_device,
]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less exit")


def test_detector_defaults_to_the_card():
    det = TagDetector("t36h11")
    assert det.device.type == "cuda" and det.device.index is None  # the current device
    assert TagDetector("t36h11", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_point_defaults_to_the_card(fn):
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default) == torch.device("cuda")


def test_render_board_image_is_a_host_function():
    """One float64 frame rendered on the host, as in the JAX package: it
    takes no device and has the reference's signature and defaults."""
    params = inspect.signature(testdata.render_board_image).parameters
    assert list(params) == [
        "model", "board", "family", "rvec", "tvec", "ss", "noise", "seed",
        "blur_sigma", "corner_squares",
    ]
    defaults = {k: v.default for k, v in params.items() if v.default is not inspect.Parameter.empty}
    assert defaults == dict(ss=3, noise=0.0, seed=0, blur_sigma=0.7, corner_squares=True)


def test_cli_platform_cpu_is_the_only_cpu_choice():
    assert cli.resolve_device("cpu") == torch.device("cpu")
    assert cli.build_parser().parse_args(["ds"]).platform == "cuda"


@pytest.mark.parametrize("flags", [[], ["--platform", "auto"]], ids=["default", "auto"])
def test_cli_without_card_exits(no_card, tmp_path, monkeypatch, flags):
    """No ``--platform`` and ``--platform auto`` exit non-zero without a
    card, before writing anything."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path / "dataset"), "--no-rerun", "-o", str(out)] + flags)
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert not out.exists() and not (tmp_path / "default_board_config.json").exists()


def test_module_entry_point_without_card_exits(no_card, tmp_path):
    """``python -m ccrs_tpu_torch <ds>`` with no ``--platform``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "ccrs_tpu_torch", str(tmp_path / "dataset"), "--no-rerun"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "default_board_config.json").exists()


@pytest.mark.parametrize("flags", [[], ["--platform", "auto"]], ids=["default", "auto"])
def test_testdata_without_card_exits(no_card, tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        testdata._main([str(tmp_path / "d"), "--frames", "1"] + flags)
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert not (tmp_path / "d").exists()
