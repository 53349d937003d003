"""Kalibr camchain export of the PyTorch port against the JAX package's.

The five cases of ``tests/test_export.py`` (EUCM stereo, the UCM -> omni
identity, KB4 and OPENCV5, an unsupported model) plus EUCMT, which Kalibr
has no model for either: both packages write the same cameras and
extrinsics, and the YAML files are equal byte for byte (tolerance 0: the
export is host arithmetic in float64 on the same numbers); for FTHETA and
EUCMT both raise the same error and write nothing.  The port's file is also read back and checked as the JAX
package's tests check theirs.
"""

import numpy as np
import pytest
import yaml

from ccrs_tpu.export import write_camchain as jax_write_camchain
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.types import RvecTvec as JaxRvecTvec
from ccrs_tpu_torch.export import write_camchain
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.types import RvecTvec

T10 = ([0.01, -0.02, 0.0], [-0.11, 0.0, 0.0])

CASES = {
    "eucm_stereo": (
        [("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512),
         ("eucm", [191.2, 191.0, 255.0, 255.5, 0.63, 1.04], 512, 512)],
        [None, T10],
    ),
    "ucm_mono": ([("ucm", [400.0, 401.0, 320.0, 240.0, 0.55], 640, 480)], None),
    "kb4_opencv5": (
        [("kb4", [300, 300, 320, 240, 0.01, -0.002, 0.0, 0.0], 640, 480),
         ("opencv5", [300, 300, 320, 240, -0.2, 0.05, 0.001, -0.001, 0.0], 640, 480)],
        [None, None],
    ),
    "eucm_rotated_pair": (
        [("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512),
         ("eucm", [461.6, 460.3, 362.7, 248.1, 0.59, 1.1], 752, 480)],
        [None, ([0.3, 0.1, -0.2], [0.05, -0.11, 0.02])],
    ),
    "ucm_three_cameras": (
        [("ucm", [471.019, 470.243, 367.122, 246.741, 0.67485], 752, 480)] * 3,
        [None, T10, ([0.0, 0.04, 0.01], [-0.22, 0.004, 0.008])],
    ),
}


def _write_both(tmp_path, specs, extrinsics):
    def rts(cls):
        if extrinsics is None:
            return None
        return [cls.identity() if e is None else cls(*e) for e in extrinsics]

    pj, pt = tmp_path / "jax.yaml", tmp_path / "torch.yaml"
    jax_write_camchain(str(pj), [JaxModel(*s) for s in specs], rts(JaxRvecTvec))
    write_camchain(str(pt), [GenericModel(*s) for s in specs], rts(RvecTvec))
    return pj, pt


@pytest.mark.parametrize("name", list(CASES))
def test_camchain_bytes_equal(tmp_path, name):
    specs, extrinsics = CASES[name]
    pj, pt = _write_both(tmp_path, specs, extrinsics)
    assert pt.read_bytes() == pj.read_bytes()
    chain = yaml.safe_load(pt.read_text())
    assert set(chain) == {f"cam{i}" for i in range(len(specs))}
    assert "T_cn_cnm1" not in chain["cam0"]
    for i, (_, _, w, h) in enumerate(specs):
        assert chain[f"cam{i}"]["resolution"] == [w, h]


def test_camchain_eucm_stereo_contents(tmp_path):
    specs, extrinsics = CASES["eucm_stereo"]
    _, pt = _write_both(tmp_path, specs, extrinsics)
    chain = yaml.safe_load(pt.read_text())
    assert chain["cam0"]["camera_model"] == "eucm" and len(chain["cam0"]["intrinsics"]) == 6
    np.testing.assert_allclose(
        np.array(chain["cam1"]["T_cn_cnm1"]), RvecTvec(*T10).to_matrix(), atol=1e-12
    )


def test_camchain_ucm_omni_identity(tmp_path):
    """The omni(xi) mapping reproduces the port's UCM projections."""
    specs, _ = CASES["ucm_mono"]
    _, pt = _write_both(tmp_path, specs, None)
    xi, fx, fy, cx, cy = yaml.safe_load(pt.read_text())["cam0"]["intrinsics"]
    pts = np.random.default_rng(0).normal(size=(50, 3)) * [0.3, 0.3, 0] + [0, 0, 1.5]
    ours, valid = GenericModel(*specs[0]).project(pts)
    d = np.linalg.norm(pts, axis=1)
    u = fx * pts[:, 0] / (pts[:, 2] + xi * d) + cx
    v = fy * pts[:, 1] / (pts[:, 2] + xi * d) + cy
    np.testing.assert_allclose(ours[valid], np.stack([u, v], 1)[valid], atol=1e-9)


def test_camchain_distortion_models(tmp_path):
    specs, extrinsics = CASES["kb4_opencv5"]
    _, pt = _write_both(tmp_path, specs, extrinsics)
    chain = yaml.safe_load(pt.read_text())
    assert chain["cam0"]["distortion_model"] == "equidistant"
    assert chain["cam1"]["distortion_model"] == "radtan"
    assert len(chain["cam1"]["distortion_coeffs"]) == 4


UNSUPPORTED = {
    "ftheta": ("ftheta", [300, 300, 320, 240, 0, 0, 0, 0, 0], 640, 480),
    "eucmt": ("eucmt", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046, 1e-4, -2e-4], 512, 512),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_camchain_unsupported_model(tmp_path, name):
    """FTHETA and EUCMT have no Kalibr counterpart: both packages raise,
    with the same message."""
    spec = UNSUPPORTED[name]
    with pytest.raises(ValueError) as want:
        jax_write_camchain(str(tmp_path / "j.yaml"), [JaxModel(*spec)])
    with pytest.raises(ValueError) as got:
        write_camchain(str(tmp_path / "t.yaml"), [GenericModel(*spec)])
    assert str(got.value) == str(want.value)
