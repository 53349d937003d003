"""Stereo run of the port's CLI against the JAX package's cold CLI
composition: a 2-camera, 14-frame rendered dataset on the rig of
``default_rig_extrinsics(2)`` (as ``tests/test_cli_stereo.py``).  Both CLIs
calibrate the same detections (the JAX one reads the port's detection
cache): intrinsics within 1e-5 relative, extrinsics within 1e-6 abs, and
the rig recovered within 2e-3."""

import numpy as np
import torch

from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.testdata import default_rig_extrinsics, write_euroc_dataset

from test_torch_cli import GT, check_against_reference, run_both

torch.set_num_threads(2)


def test_cli_stereo_matches_reference(tmp_path):
    rig = default_rig_extrinsics(2)
    ds = str(tmp_path / "dataset")
    write_euroc_dataset(
        ds, GenericModel("eucm", GT, 512, 512), n_frames=14, cam_num=2,
        extrinsics=rig, seed=6, noise=1.5,
        device="cpu",
    )
    port, jax, _ = run_both(tmp_path, ds, ["--model", "eucm", "--cam-num", "2", "--seed", "3"])
    ext = check_against_reference(port, jax, 2)
    np.testing.assert_allclose(ext[1]["rvec"], rig[1][:3], atol=2e-3)
    np.testing.assert_allclose(ext[1]["tvec"], rig[1][3:], atol=2e-3)
