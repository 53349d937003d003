"""Tracing / profiling helpers (port of ``ccrs_tpu/utils/profiling.py``).

Scoped wall-clock timers that aggregate per stage, counters, and a context
manager that captures a ``torch.profiler`` trace of the host and, when a
card is present, of CUDA.

Enable stage timing with CCRS_TIMING=1 (report printed at exit) or
``enable()``, and device traces with ``with_profiler(logdir)`` or the CLI's
``CCRS_PROFILE_DIR`` environment variable.  ``stage_prefix`` prefixes the
stage and counter names of the calling thread only, so the speculative
calibration's thread reports ``spec/...`` stages beside the main thread's.
CCRS_TIMING_SPANS=1 also records every stage as a (name, thread, t0, t1)
span, for laying overlapped threads out on a timeline (``spans()``).

Each layer of a calibration job opens a root stage, and the host steps
between its device calls have stages of their own, so that a traced job
leaves little of the main thread unnamed:

- detection (``detect/tracked.py``): ``detect/tracked`` around one
  camera's tracked detection; inside it the existing ``detect/track``,
  ``detect/track-cold``, ``detect/track-audit`` and the cold path's
  ``detect/threshold|quadproc|dispatch|decode|assist``, plus
  ``detect/results`` (row layout and the first results) and
  ``detect/audit-plan`` (each audit round's planning and result writing);
- calibration (``calib/pipeline.py``): ``calib/camera`` around one
  camera's ladder; inside it ``calib/spec-wait`` (the join of the
  speculation thread), ``calib/pick-frames``, ``calib/init``,
  ``calib/convert``, ``calib/ba``, ``calib/sanity-gate``; and
  ``calib/frames`` around ``FrameBatch.from_detections``;
- the joint solve (``calib/multi.py``): ``joint/init-extrinsic`` and
  ``joint/ba``, with ``joint/assemble`` (host arrays and uploads).

Counters (``count``, ``counters()``) are taken at the same boundaries:
``detect/frames`` and ``detect/cold-frames`` per tracked detection,
``calib/cameras``, ``calib/warm-offered`` and ``calib/warm-used`` per
ladder.  Like stages they are no-ops unless timing is enabled and take the
calling thread's prefix.

While a ``torch.profiler`` session is active, each stage also opens a
``torch.profiler.record_function`` range of its name, so the stages land
in the profiler's trace on its clock, beside the kernels they launch.
``with_profiler`` turns stage timing on for its session and records every
thread (the speculation and warm-up threads too).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import threading
import time

import torch

_ENABLED = os.environ.get("CCRS_TIMING", "") not in ("", "0")
_SPANS = os.environ.get("CCRS_TIMING_SPANS", "") not in ("", "0")
_totals: dict = collections.defaultdict(float)
_counts: dict = collections.defaultdict(int)
_counters: dict = collections.defaultdict(int)
_span_list: list = []
_lock = threading.Lock()
_tls = threading.local()
# torch.profiler's own flag of an active session: global, where
# torch._C._autograd._profiler_enabled() is per thread (and reads False in a
# session that profiles all threads)
_autograd_profiler = torch.autograd.profiler


_OFF = contextlib.nullcontext()


def stage(name: str):
    """Accumulating wall-clock timer; no-op unless enabled (one shared
    null context, not a generator per call).  Inside an active
    torch.profiler session also a ``record_function`` range."""
    if not _ENABLED:
        return _OFF
    return _timed(getattr(_tls, "prefix", "") + name)


@contextlib.contextmanager
def _timed(name: str):
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if rf is not None:
            rf.__exit__(None, None, None)
        with _lock:
            _totals[name] += t1 - t0
            _counts[name] += 1
            if _SPANS and len(_span_list) < 100_000:
                _span_list.append((name, threading.current_thread().name, t0, t1))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (with the thread's prefix); no-op
    unless enabled."""
    if not _ENABLED:
        return
    name = getattr(_tls, "prefix", "") + name
    with _lock:
        _counters[name] += n


@contextlib.contextmanager
def stage_prefix(prefix: str):
    """Prefix the stage and counter names of the CURRENT thread (e.g.
    "spec/" for the speculative calibration, so its overlapped time is not
    counted as the critical path's calibrate stages)."""
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
    if _counters:
        lines.append("ccrs counters:")
        lines.extend(f"  {name:30s} {n:8d}" for name, n in sorted(_counters.items()))
    return "\n".join(lines)


def reset() -> None:
    """Clear accumulated stage totals, counters and spans (e.g. after a
    warmup run)."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _counters.clear()
        _span_list.clear()


def totals() -> dict:
    """Snapshot of accumulated stage wall-clock seconds."""
    with _lock:
        return dict(_totals)


def counters() -> dict:
    """Snapshot of the counters."""
    with _lock:
        return dict(_counters)


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
    present) of every thread, with the stages as ranges, and write it as a
    Chrome trace under ``logdir``."""
    global _ENABLED

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        ),
    )
    was = _ENABLED
    _ENABLED = True
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _ENABLED = was
        prof.export_chrome_trace(
            os.path.join(logdir, f"ccrs_trace_{os.getpid()}.json")
        )
