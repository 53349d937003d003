"""The PyTorch port imports with jax unavailable and never imports the JAX
package: every module of ``ccrs_tpu_torch`` is imported, and ``python -m
ccrs_tpu_torch --help``, ``python -m ccrs_tpu_torch.testdata --help`` and
``python -m ccrs_tpu_torch.make_board --help`` run, in a subprocess in which ``import jax`` fails."""

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
for name in ("parallel.mesh", "models.undistort", "examples.convert_model", "examples.test_pnp",
             "make_board", "detect.ccl", "calib.prewarm"):
    assert "ccrs_tpu_torch." + name in names, name
import contextlib, io, runpy
for entry in ("ccrs_tpu_torch", "ccrs_tpu_torch.testdata", "ccrs_tpu_torch.make_board"):
    sys.argv = [entry, "--help"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(entry, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (entry, e.code)
    else:
        raise AssertionError(f"{entry} --help did not exit")
    assert "usage:" in out.getvalue(), out.getvalue()
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
    assert int(out.stdout.strip()) >= 50  # every module of the package


def test_no_jax_import_in_port_sources():
    """No source of the port, of chip_smoke.py or of the port's two bench
    programs names jax."""
    paths = [os.path.join(REPO, p) for p in
             ("chip_smoke.py", "bench_torch.py", "bench_multicam_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ccrs_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (p, s)
