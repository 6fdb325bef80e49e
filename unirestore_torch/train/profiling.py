"""Profiling and step timing (the port of ``unirestore_tpu/train/profiling.py``).

- ``trace(logdir)``: context manager around ``torch.profiler`` (host and CUDA
  activities) that writes a Chrome trace (``trace.json``) into ``logdir``,
  viewable in Perfetto or ``chrome://tracing``; the JAX file captured a
  ``jax.profiler`` device trace. ``device_summary`` reads the card's busy
  time, span and idle share from the finished profile.
- ``StepTimer``: wall-clock per-step timing with warmup skip and percentile
  summaries; drives the imgs/sec numbers the Trainer logs. Copied as it is.
- ``annotate``: a named span in the trace (``torch.profiler.record_function``
  in place of ``jax.profiler.TraceAnnotation``).

Enable from the CLI via ``--trainer.profiler <logdir>`` (config.py) or
programmatically.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, when a card is present, CUDA activity) and
    write ``<logdir>/trace.json``; yields the ``torch.profiler.profile``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_summary(prof) -> dict:
    """The card's time in a finished profile: summed kernel time
    (``device_busy_s``), first kernel start to last kernel end
    (``device_span_s``), ``device_idle_share`` = 1 - busy / span, and the
    number of kernels. Empty when no device activity was recorded. Read from
    the profiler's raw kineto events: ``prof.events()`` first builds a record
    of every host event, tens of seconds of host time for a training step's
    trace."""
    busy_ns, n, first, last = 0, 0, float("inf"), float("-inf")
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation():
            busy_ns += evt.duration_ns()
            first, last = min(first, evt.start_ns()), max(last, evt.end_ns())
            n += 1
    if not n:
        return {}
    busy, span = busy_ns / 1e9, (last - first) / 1e9
    return {"device_busy_s": busy, "device_span_s": span,
            "device_idle_share": 1.0 - busy / span if span > 0 else None, "kernels": n}


def annotate(name: str):
    """Named span inside a trace (``record_function``)."""
    return record_function(name)


class StepTimer:
    """Per-step wall-clock stats with compile-step exclusion."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._skipped = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._skipped < self.warmup:
            self._skipped += 1
        else:
            self.times.append(dt)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "min_s": ts[0],
            "p50_s": ts[n // 2],
            "p90_s": ts[min(n - 1, int(n * 0.9))],
            "max_s": ts[-1],
        }
