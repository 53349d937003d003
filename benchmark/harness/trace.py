"""The traced run's readings: torch.profiler over the first jobs of the window.

The profiler's device events give the busy time (the union of every
kernel, copy and set on the card), the device time by operation name and
the idle gaps; each gap is labelled by the program's stage that was open
on the detecting thread at its middle (``utils/profiling.spans``), or
"no stage open".  A ``record_function`` mark at each traced job's start
ties the profiler's clock to ``time.perf_counter``.  The threshold
kernel's input shapes come from a recorder around the detector's call of
its front end (``detector.threshold_front``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

MARK = "bench_job"


class ThresholdShapes:
    """Records (B, H, W, itemsize, scale) of each call of the threshold
    kernel's front end by the detector while installed; the call itself
    is the program's, unchanged."""

    def __init__(self):
        self.shapes = []
        self._mod = None
        self._orig = None

    def install(self) -> None:
        from ccrs_tpu_torch.detect import detector as mod

        orig = mod.threshold_front
        shapes = self.shapes

        def recorded(images, scale=1, *args, **kwargs):
            out = orig(images, scale, *args, **kwargs)
            shapes.append((*images.shape, images.element_size(), scale))
            return out

        self._mod, self._orig = mod, orig
        mod.threshold_front = recorded

    def remove(self) -> None:
        if self._mod is not None:
            self._mod.threshold_front = self._orig
            self._mod = None


class Profiler:
    """Profiles jobs 0 .. n_jobs-1 of the window as one session."""

    def __init__(self, n_jobs: int):
        self.n_jobs = n_jobs
        self.prof = None
        self.marks = []  # perf_counter at each traced job's mark
        self.shapes = ThresholdShapes()

    @contextlib.contextmanager
    def around(self, k: int):
        if k == 0 and self.n_jobs > 0:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.shapes.install()
        traced = self.prof is not None and k < self.n_jobs
        if traced:
            with torch.profiler.record_function(MARK):
                self.marks.append(time.perf_counter())
                yield
        else:
            yield
        if traced and k == self.n_jobs - 1:
            self.shapes.remove()
            self.prof.stop()

    def finish(self) -> None:
        """Stop the session if the window ended before its last traced job."""
        if self.prof is not None and self.shapes._mod is not None:
            self.shapes.remove()
            self.prof.stop()

    def digest(self, spans: list, detect_thread: str) -> dict:
        """Busy and window seconds, device time by name, idle gaps by stage,
        and the threshold kernel's seconds and launch shapes."""
        evs = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        marks = sorted((e.start_ns(), e.end_ns()) for e in evs
                       if e.name() == MARK and e.device_type() != cuda)
        dev = sorted((e.start_ns(), e.end_ns(), e.name()) for e in evs
                     if e.device_type() == cuda and not e.is_user_annotation()
                     and e.end_ns() > e.start_ns())
        w0, w1 = marks[0][0], marks[-1][1]
        offset = sum(pc - m[0] * 1e-9 for pc, m in zip(self.marks, marks)) / len(marks)
        label = _Stages(spans, detect_thread)
        by_name = collections.defaultdict(float)
        busy = 0
        gaps = collections.defaultdict(float)
        cursor = w0
        for a, b, name in dev:
            by_name[name] += (b - a) * 1e-9
            a, b = max(a, cursor), min(b, w1)
            if b <= a:
                continue
            if a > cursor:
                gaps[label.at((a + cursor) * 0.5e-9 + offset)] += (a - cursor) * 1e-9
            busy += b - a
            cursor = b
        if w1 > cursor:
            gaps[label.at((w1 + cursor) * 0.5e-9 + offset)] += (w1 - cursor) * 1e-9
        thr = sum(s for n, s in by_name.items() if "threshold_kernel" in n)
        return {
            "busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9, "jobs": len(marks),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
            "threshold_s": thr, "threshold_shapes": list(self.shapes.shapes),
        }


class _Stages:
    """The innermost program stage open on one thread, as a step function of
    time (a thread's stages nest)."""

    def __init__(self, spans: list, thread: str):
        self.times, self.names = [], []
        stack = []

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end = stack.pop()[0]
                self._step(end, stack[-1][1] if stack else None)

        for a, b, name in sorted(((a, b, n) for n, thr, a, b in spans if thr == thread),
                                 key=lambda s: (s[0], -s[1])):
            close_until(a)
            stack.append((b, name))
            self._step(a, name)
        close_until(float("inf"))

    def _step(self, t: float, name) -> None:
        self.times.append(t)
        self.names.append(name)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        name = self.names[i] if i >= 0 else None
        return name or "no stage open"
