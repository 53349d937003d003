"""Tracing / profiling helpers (port of ``ccrs_tpu/utils/profiling.py``).

Scoped wall-clock timers that aggregate per stage, plus a context manager
that captures a ``torch.profiler`` trace of the host and, when a card is
present, of CUDA.

Enable stage timing with CCRS_TIMING=1 (report printed at exit) or
``enable()``, and device traces with ``with_profiler(logdir)`` or the CLI's
``CCRS_PROFILE_DIR`` environment variable.  ``stage_prefix`` prefixes the
stage names of the calling thread only, so the speculative calibration's
thread reports ``spec/...`` stages beside the main thread's.
CCRS_TIMING_SPANS=1 also records every stage as a (name, thread, t0, t1)
span, for laying overlapped threads out on a timeline (``spans()``).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import threading
import time

_ENABLED = os.environ.get("CCRS_TIMING", "") not in ("", "0")
_SPANS = os.environ.get("CCRS_TIMING_SPANS", "") not in ("", "0")
_totals: dict = collections.defaultdict(float)
_counts: dict = collections.defaultdict(int)
_span_list: list = []
_lock = threading.Lock()
_tls = threading.local()


@contextlib.contextmanager
def stage(name: str):
    """Accumulating wall-clock timer; no-op unless enabled."""
    if not _ENABLED:
        yield
        return
    name = getattr(_tls, "prefix", "") + name
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        with _lock:
            _totals[name] += t1 - t0
            _counts[name] += 1
            if _SPANS and len(_span_list) < 100_000:
                _span_list.append((name, threading.current_thread().name, t0, t1))


@contextlib.contextmanager
def stage_prefix(prefix: str):
    """Prefix the stage names of the CURRENT thread (e.g. "spec/" for the
    speculative calibration, so its overlapped time is not counted as the
    critical path's calibrate stages)."""
    prev = getattr(_tls, "prefix", "")
    _tls.prefix = prev + prefix
    try:
        yield
    finally:
        _tls.prefix = prev


def report() -> str:
    lines = ["ccrs timing report:"]
    for name, total in sorted(_totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:30s} {total:8.3f}s  x{_counts[name]}")
    return "\n".join(lines)


def reset() -> None:
    """Clear accumulated stage totals and spans (e.g. after a warmup run)."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _span_list.clear()


def totals() -> dict:
    """Snapshot of accumulated stage wall-clock seconds."""
    with _lock:
        return dict(_totals)


def spans() -> list:
    """Snapshot of (name, thread, t0, t1) spans (CCRS_TIMING_SPANS=1)."""
    with _lock:
        return list(_span_list)


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
