"""The measured window: whole jobs, one client, closed loop.

Jobs start one after another while less than ``seconds`` has passed since
the first one started; the window closes when the last started job ends.
A rate is then all the work of the timed jobs over the time from the
first job's start to the last job's end, so no job is cut or left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, List


@dataclasses.dataclass
class Job:
    index: int
    start: float
    end: float
    output: Any = None
    error: str | None = None


def run_window(job: Callable[[int], Any], seconds: float, clock=time.perf_counter,
               around: Callable[[int], Any] | None = None) -> List[Job]:
    """Run ``job(k)`` for k = 0, 1, ... as set out above.  ``around(k)``,
    when given, returns a context manager entered around job k (the
    traced run's profiler).  A job that raises is recorded with its
    error and the loop goes on."""
    jobs: List[Job] = []
    first = None
    k = 0
    while first is None or clock() - first < seconds:
        with around(k) if around is not None else contextlib.nullcontext():
            t0 = clock()
            if first is None:
                first = t0
            try:
                out, err = job(k), None
            except Exception as e:  # counted as failed; the run reports it
                out, err = None, f"{type(e).__name__}: {e}"
            jobs.append(Job(k, t0, clock(), out, err))
        k += 1
    return jobs


def window_seconds(jobs: List[Job]) -> float:
    """From the first job's start to the last job's end."""
    return jobs[-1].end - jobs[0].start
