"""The PyTorch port imports with jax unavailable and never imports the JAX
package: every module of ``ccrs_tpu_torch`` is imported in a subprocess in
which ``import jax`` fails."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import ccrs_tpu_torch
names = ["ccrs_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ccrs_tpu_torch.__path__, "ccrs_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "ccrs_tpu" or m.startswith("ccrs_tpu."))
assert not bad, bad
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the slice


def test_no_jax_import_in_port_sources():
    """No source of the port or of chip_smoke.py names jax."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ccrs_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (p, s)
