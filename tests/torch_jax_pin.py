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
import pytest


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_traces():
    """Drop every JAX trace before the module's first test."""
    jax.clear_caches()
