"""Profiling / tracing helpers.

The reference's profiling is vestigial (commented cProfile/line_profiler
hooks, ``RIPTRM.py:6,908,1051``) plus wall-clock ``excluded_time``
bookkeeping.  The replacements here:

* ``trace(logdir)``: context manager around ``jax.profiler`` producing a
  TensorBoard-compatible device trace of the solver hot loop;
* ``device_timer``: per-call device wall time via ``block_until_ready``;
* ``annotate``: named ``TraceAnnotation`` regions visible in the trace.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/riptrm_trace"):
    """Capture a device trace: ``with trace("dir"): run_solver()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region for the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


def device_timer(fn, *args, warmup: int = 1, reps: int = 10):
    """Median device wall time of fn(*args) in seconds."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
