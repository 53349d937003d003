"""The JAX reference's state, pinned for the port's parity tests.

``tests/test_detector.py``'s chunk-plan tests trace the JAX detector with
``jax.default_backend`` patched to "tpu", which picks the TPU's bf16
matmul formulation while tracing, and jit caches key on shapes only: a
later CPU call with the same chunk shape in the same process reuses those
traces and detects differently (a lost tag, corners 3e-3 px off).  A parity
module that runs the JAX detector takes the fixture below::

    from torch_jax_pin import fresh_jax_traces  # noqa: F401 (autouse)

so its JAX side traces afresh whatever ran before it in the process.
"""

import jax
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_traces():
    """Drop every JAX trace before the module's first test."""
    jax.clear_caches()


def assert_same_detections(got, want, tol=1e-3):
    """Per frame the same tag ids, and every corner within ``tol`` px;
    ``got`` and ``want`` are lists of {tag id: (4, 2) corners}.  Returns the
    largest corner difference seen."""
    assert len(got) == len(want), f"{len(got)} frames vs {len(want)}"
    worst = 0.0
    for f, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (
            f"frame {f}: tags only in the port {sorted(set(g) - set(w))}, "
            f"only in ccrs_tpu {sorted(set(w) - set(g))}"
        )
        for t in g:
            err = float(np.abs(np.asarray(g[t]) - np.asarray(w[t])).max())
            assert err <= tol, f"frame {f} tag {t}: corners differ by {err:.3e} px"
            worst = max(worst, err)
    return worst
