"""UCM/EUCM camera models of the PyTorch port against the JAX package, in
float64: projections within 1e-12 (same closed forms, rounding only) and
forward-mode Jacobians within 1e-10."""

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
}


def _points(seed=0, n=400):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * [0.8, 0.8, 0.6] + [0.0, 0.0, 0.4]
    p[:4] = [[0, 0, 1], [0, 0, -1], [1e-9, 0, 1], [0.3, -0.2, 0]]  # edge cases
    return p


@pytest.mark.parametrize("name", ["ucm", "eucm"])
def test_project_unproject_match(name):
    params = PARAMS[name]
    p3d = _points()
    jp, jv = JP.project(name, jnp.asarray(params), jnp.asarray(p3d))
    tp, tv = TP.project(name, torch.as_tensor(params), torch.as_tensor(p3d))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], rtol=1e-12, atol=1e-12)

    rng = np.random.default_rng(1)
    p2d = rng.uniform(0, 512, size=(300, 2))
    ju, juv = JP.unproject(name, jnp.asarray(params), jnp.asarray(p2d))
    tu, tuv = TP.unproject(name, torch.as_tensor(params), torch.as_tensor(p2d))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["ucm", "eucm"])
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


def test_model_json_and_bounds_match():
    for name, params in PARAMS.items():
        jm = JaxModel(name, params, 752, 480)
        tm = GenericModel(name, params, 752, 480)
        assert tm.to_json() == jm.to_json()
        assert tm.distortion_params_bound() == jm.distortion_params_bound()
        assert GenericModel.from_json(jm.to_json()).params.tolist() == params.tolist()
        np.testing.assert_allclose(
            tm.project(_points(3, 20))[0], jm.project(_points(3, 20))[0],
            rtol=0, atol=1e-9,
        )


def test_unported_models_raise():
    for name in ("eucmt", "kb4", "opencv5", "ftheta"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
            TP.project_fn(name)
