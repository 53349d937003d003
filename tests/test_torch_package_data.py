"""The port carries its own copies of the two files it once read from the
JAX package's tree: the tag-code table and the quad extractor's C++
source.  The copies equal the JAX package's files byte for byte (so drift
shows), no source of the port names a path under ``ccrs_tpu/``, and the
detector finds its codes and builds the quad extractor from a copy of the
port with no ``ccrs_tpu/`` beside it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ccrs_tpu_torch")

COPIES = [
    ("ccrs_tpu_torch/detect/data/tag_families.npz", "ccrs_tpu/detect/data/tag_families.npz"),
    ("ccrs_tpu_torch/csrc/quadproc.cpp", "ccrs_tpu/native/quadproc.cpp"),
]


def _port_sources():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("copy,original", COPIES, ids=["tag_families", "quadproc"])
def test_copy_equals_the_jax_package_file(copy, original):
    with open(os.path.join(REPO, copy), "rb") as a, open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read(), f"{copy} drifted from {original}"


def test_no_port_source_names_a_path_under_the_jax_package():
    """Every string of every module (docstrings aside, which name the JAX
    module each one ports) is free of a ``ccrs_tpu`` path component."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        docstrings = {
            id(node.body[0].value)
            for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings):
                parts = node.value.replace("\\", "/").split("/")
                if "ccrs_tpu" in parts:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {node.value!r}")
    assert not bad, bad
    assert len(list(_port_sources())) >= 50


_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ccrs_tpu"] = None
from ccrs_tpu_torch.detect import get_family
from ccrs_tpu_torch.detect import quads
fam = get_family("t36h11")
assert fam.codes.shape == (587, 36), fam.codes.shape
so = quads.build()
assert so.startswith(sys.argv[1]), so
quads._load()
print("ok", so)
"""


def test_port_runs_with_the_jax_package_hidden(tmp_path):
    """A copy of the port alone (no ``ccrs_tpu/``, no built libraries)
    reads its tag codes and compiles and loads its quad extractor."""
    dst = tmp_path / "ccrs_tpu_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert not (tmp_path / "ccrs_tpu").exists()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(dst)], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok"), out.stdout
