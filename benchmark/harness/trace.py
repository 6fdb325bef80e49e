"""The traced window: ``torch.profiler`` over a number of whole calls, reduced
to what the per-layer readers take.

- ``busy_s``: the union of the device's operations (kernels, copies, sets);
- ``window_s``: the host clock from the first call's start to the card's
  last synchronise;
- ``family_s``: device seconds by kernel family (``reference.kernels``);
- ``hand_kernels``: launches and device seconds of each hand kernel;
- ``device_ops`` / ``idle_gaps``: the ten longest device operations by name,
  and the ten longest idle stretches, each named by the innermost span of the
  benchmark's own (``record_function``) that the host was in at its middle.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..reference import kernels as RK


def _device_events(prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def _merged(intervals: list) -> list:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _host_span_at(spans: list, t: float) -> str:
    """The innermost benchmark span around host time ``t`` (µs)."""
    inside = [s for s in spans if s[0] <= t <= s[1]]
    return min(inside, key=lambda s: s[1] - s[0])[2] if inside else "outside the spans"


def traced(fn, calls: int) -> dict:
    """Run ``fn(i)`` for i < ``calls`` under the profiler; the reduced record
    (without a card, as the CPU tests run it, no device operation)."""
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        sync()
        window = time.perf_counter() - t0
    events = _device_events(prof)
    family_s, op_s = defaultdict(float), defaultdict(float)
    hand = defaultdict(lambda: {"count": 0, "seconds": 0.0})
    for e in events:
        sec = e.time_range.elapsed_us() / 1e6
        family_s[RK.family(e.name)] += sec
        op_s[e.name[:120]] += sec
        kern = RK.hand_kernel(e.name)
        if kern is not None:
            hand[kern]["count"] += 1
            hand[kern]["seconds"] += sec
    busy = _merged([(e.time_range.start, e.time_range.end) for e in events])
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation]
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])]
    gaps.sort(reverse=True)
    return {
        "window_s": window,
        "busy_s": sum(end - start for start, end in busy) / 1e6,
        "family_s": dict(family_s),
        "hand_kernels": {k: dict(v) for k, v in hand.items()},
        "device_ops": sorted(op_s.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_host_span_at(spans, mid), us / 1e6] for us, mid in gaps[:10]],
        "calls": calls,
    }
