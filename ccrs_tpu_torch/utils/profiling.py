"""Tracing / profiling helpers (port of ``ccrs_tpu/utils/profiling.py``).

Scoped wall-clock timers that aggregate per stage, plus a context manager
that captures a ``torch.profiler`` trace of the host and, when a card is
present, of CUDA.

Enable stage timing with CCRS_TIMING=1 (report printed at exit) or
``enable()``, and device traces with ``with_profiler(logdir)`` or the CLI's
``CCRS_PROFILE_DIR`` environment variable.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import threading
import time

_ENABLED = os.environ.get("CCRS_TIMING", "") not in ("", "0")
_totals: dict = collections.defaultdict(float)
_counts: dict = collections.defaultdict(int)
_lock = threading.Lock()


@contextlib.contextmanager
def stage(name: str):
    """Accumulating wall-clock timer; no-op unless enabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def report() -> str:
    lines = ["ccrs timing report:"]
    for name, total in sorted(_totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:30s} {total:8.3f}s  x{_counts[name]}")
    return "\n".join(lines)


def reset() -> None:
    """Clear accumulated stage totals (e.g. after a warmup run)."""
    _totals.clear()
    _counts.clear()


def totals() -> dict:
    """Snapshot of accumulated stage wall-clock seconds."""
    return dict(_totals)


def enable() -> None:
    """Turn stage timing on programmatically."""
    global _ENABLED
    _ENABLED = True


if _ENABLED:  # pragma: no cover
    atexit.register(lambda: print(report()))


@contextlib.contextmanager
def with_profiler(logdir: str):
    """Capture a ``torch.profiler`` trace (host, plus CUDA when a card is
    present) and write it as a Chrome trace under ``logdir``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"ccrs_trace_{os.getpid()}.json")
        )
