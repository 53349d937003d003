"""Build-at-first-use for the port's native libraries.

Both shared libraries — the CUDA kernels (``csrc/*.cu``, by nvcc) and the
host quad extractor (``csrc/quadproc.cpp``, by g++) — are
compiled into ``ccrs_tpu_torch/_build/`` the first time they are needed and
rebuilt when a source is newer than the library.  A failed build raises
with the compiler's stderr.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_locks: dict = {}  # one lock per library: different libraries build in parallel
_locks_guard = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels of ccrs_tpu_torch are built from source at first use"
        )
    return found


def ensure_built(so_path: str, sources, cmd, log_path: str | None = None) -> str:
    """Run ``cmd`` (which writes ``so_path``) unless the library exists and
    is newer than every source.  Returns ``so_path``.  ``log_path``: where a
    successful build leaves the compiler's output (e.g. ``ptxas -v``)."""
    with _locks_guard:
        lock = _locks.setdefault(so_path, threading.Lock())
    with lock:
        if os.path.exists(so_path) and all(
            os.path.getmtime(so_path) >= os.path.getmtime(s) for s in sources
        ):
            return so_path
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        # build to a temporary name and rename: a reader never sees a
        # half-written library
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [tmp if a == so_path else a for a in cmd]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(so_path)} failed "
                f"(exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        if log_path is not None:
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
        return so_path
