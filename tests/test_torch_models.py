"""The six camera models of the PyTorch port against the JAX package, in
float64.  UCM/EUCM projections agree within 1e-12 (same closed forms,
rounding only); EUCMT/KB4/OPENCV5/FTHETA, whose unprojections iterate a
fixed number of steps, within 1e-10 abs on valid points.  Validity masks
are exact, forward-mode Jacobians agree within 1e-10, and the tagged-enum
JSON text is equal to the JAX package's ``model_to_json`` output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.models import projections as JP
from ccrs_tpu_torch.models import GenericModel, projections as TP
from ccrs_tpu_torch.solve.se3 import transform

torch.set_num_threads(1)

PARAMS = {
    "ucm": np.array([470.3, 468.9, 367.1, 246.7, 0.67]),
    "eucm": np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046]),
    "eucmt": np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046, 0.0012, -0.0008]),
    "kb4": np.array([190.0, 190.2, 256.0, 255.0, 0.01, -0.005, 0.002, -0.0003]),
    "opencv5": np.array([420.0, 421.0, 258.0, 254.0, -0.25, 0.06, 0.0008, -0.0005, -0.007]),
    "ftheta": np.array([190.4, 190.1, 255.5, 255.9, 0.015, -0.006, 0.002, -0.0004, 0.0001]),
}
#: absolute tolerance per model: closed forms round alike to 1e-12; the
#: fixed-count iterative inversions to 1e-10
ATOL = {"ucm": 1e-12, "eucm": 1e-12, "eucmt": 1e-10, "kb4": 1e-10,
        "opencv5": 1e-10, "ftheta": 1e-10}


def _points(seed=0, n=400):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * [0.8, 0.8, 0.6] + [0.0, 0.0, 0.4]
    p[:4] = [[0, 0, 1], [0, 0, -1], [1e-9, 0, 1], [0.3, -0.2, 0]]  # edge cases
    return p


@pytest.mark.parametrize("name", list(PARAMS))
def test_project_unproject_match(name):
    params = PARAMS[name]
    atol = ATOL[name]
    p3d = _points()
    jp, jv = JP.project(name, jnp.asarray(params), jnp.asarray(p3d))
    tp, tv = TP.project(name, torch.as_tensor(params), torch.as_tensor(p3d))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], rtol=atol, atol=atol)

    rng = np.random.default_rng(1)
    p2d = rng.uniform(0, 512, size=(300, 2))
    ju, juv = JP.unproject(name, jnp.asarray(params), jnp.asarray(p2d))
    tu, tuv = TP.unproject(name, torch.as_tensor(params), torch.as_tensor(p2d))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    ok = np.asarray(juv)
    np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok], rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(PARAMS))
def test_jacobians_match(name):
    """d(pixels)/d(params) and d(pixels)/d(pose) through the BA residual
    body, torch.func.jacfwd against jax.jacfwd."""
    from ccrs_tpu.solve import se3 as jse3

    params = PARAMS[name]
    pose = np.array([0.1, -0.2, 3.0, 0.05, -0.03, 0.6])
    p3d = _points(2, 50) * 0.2

    def jf(th, po):
        return JP.project(name, th, jse3.transform(po[:3], po[3:], jnp.asarray(p3d)))[0]

    def tf(th, po):
        return TP.project(name, th, transform(po[:3], po[3:], torch.as_tensor(p3d)))[0]

    jt, jpo = jax.jacfwd(jf, argnums=(0, 1))(jnp.asarray(params), jnp.asarray(pose))
    tt, tpo = torch.func.jacfwd(tf, argnums=(0, 1))(
        torch.as_tensor(params), torch.as_tensor(pose)
    )
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tpo.numpy(), np.asarray(jpo), rtol=1e-10, atol=1e-10)


def test_model_json_and_bounds_match(tmp_path):
    from ccrs_tpu.models import model_to_json as jax_model_to_json
    from ccrs_tpu_torch.models import model_to_json

    for name, params in PARAMS.items():
        jm = JaxModel(name, params, 752, 480)
        tm = GenericModel(name, params, 752, 480)
        assert tm.to_json() == jm.to_json()
        jax_model_to_json(str(tmp_path / "j.json"), jm)
        model_to_json(str(tmp_path / "t.json"), tm)
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
        assert tm.distortion_params_bound() == jm.distortion_params_bound()
        assert GenericModel.from_json(jm.to_json()).params.tolist() == params.tolist()
        jp, jv = jm.project(_points(3, 20))
        tp, tv = tm.project(_points(3, 20))
        np.testing.assert_array_equal(tv, jv)
        if name in ("ucm", "eucm"):
            np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
        else:
            # valid points only; near z = 0 pixels run to ~1e8, where the
            # bound is relative
            np.testing.assert_allclose(tp[jv], jp[jv], rtol=1e-12, atol=1e-9)


def test_unported_models_raise():
    """Every model of the JAX package is ported; a name neither package
    knows still raises."""
    assert TP.MODEL_NAMES == JP.MODEL_NAMES and TP.N_PARAMS == JP.N_PARAMS
    for name in TP.MODEL_NAMES:
        assert TP.project_fn(name) is not None and TP.unproject_fn(name) is not None
    with pytest.raises(KeyError):
        TP.project_fn("pinhole")
    with pytest.raises(ValueError, match="unknown camera model"):
        GenericModel("pinhole", [1.0, 1.0, 0.0, 0.0], 10, 10)


@pytest.mark.parametrize("target", ["eucmt", "kb4", "opencv5", "ftheta"])
def test_convert_from_ucm_matches_reference(target):
    """convert_model fits every non-UCM target through the dense LM core
    (EUCMT by the analytic embed); UCM -> KB4/OPENCV5/FTHETA land where the
    JAX package's conversion lands, within 1e-6 relative in parameters."""
    from ccrs_tpu.calib.convert import convert_model as jax_convert
    from ccrs_tpu.models import zeros_like_model as jax_zeros
    from ccrs_tpu_torch.calib.convert import convert_model
    from ccrs_tpu_torch.models import zeros_like_model

    src = np.array([190.5, 190.2, 255.2, 256.1, 0.63])
    j_tgt = jax_zeros(target, 512, 512)
    t_tgt = zeros_like_model(target, 512, 512)
    jax_convert(JaxModel("ucm", src, 512, 512), j_tgt)
    convert_model(GenericModel("ucm", src, 512, 512), t_tgt, device="cpu")
    assert np.isfinite(t_tgt.params).all()
    np.testing.assert_allclose(t_tgt.params, j_tgt.params, rtol=1e-6, atol=1e-9)
