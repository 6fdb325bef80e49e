"""Device time of a call on the card (the port of ``tools/profile_components.py:
timeit``, :33-59).

The JAX tool runs ITERS calls inside one ``lax.scan`` so that the TPU's
dispatch is paid once, and perturbs the carry so that XLA can neither hoist
the loop-invariant body nor drop iterations. Eager PyTorch hoists and drops
nothing, so here ``timeit`` brackets ITERS launches with CUDA events after
one warm-up, keeps the best of two such windows and divides by ITERS:

- the eager route: ``fn()`` itself, launched back to back;
- the graph route (the port's counterpart of ``jax.jit``): ``fn`` captured
  once into a CUDA graph (``CapturedCall``, as ``graphs.GraphedCall``
  captures a network) and the graph replayed.

A call that reads under ``GRAPH_MS`` either way is timed again with the host
out of the way: ``GRAPH_CALLS`` calls captured in one graph and replayed, as
``chip_smoke.py`` times its short kernels (back-to-back short calls time the
host's launch rate, not the card). The timer used is returned beside the
time.

Every function here needs a CUDA device (``card``); there is no CPU route.
``card_line`` is the card's name and power limit as ``nvidia-smi`` gives
them, which every printed time carries.
"""

from __future__ import annotations

import subprocess

import torch

from ..device import resolve_device

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# a call shorter than GRAPH_MS is timed by replaying GRAPH_CALLS captured
# calls: one ctypes call costs 4-9 us of host time and a wrapper call 40-115
# us, so back-to-back calls of a short kernel measure the host's launch rate
GRAPH_MS = 0.05
GRAPH_CALLS = 100


def card(device=None) -> torch.device:
    """The CUDA device to measure on (``resolve_device``), or an error: the
    diagnostics time and measure the card and have no CPU route."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the diagnostics measure the card "
                           "and have no CPU route")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the diagnostics measure a CUDA device, got {dev}")
    return dev


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of the
    first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class CapturedCall:
    """``fn()`` (no arguments; it reads tensors already on the card) captured
    once into a CUDA graph: one eager call on a side stream first (lazy
    library and workspace set-up), then the capture. ``first`` is that eager
    call's output and ``out`` the graph's static output, which each
    ``replay()`` refills and returns. ``after_first()``, if given, runs between
    the eager call and the capture (to read what the eager call counted)."""

    def __init__(self, fn, after_first=None):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.first = fn()
        current.wait_stream(side)
        torch.cuda.synchronize()
        if after_first is not None:
            after_first()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()

    def replay(self):
        self.graph.replay()
        return self.out


def _window_ms(call, iters: int) -> float:
    """Best of two event windows of ``iters`` calls, ms a call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(2):
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device ms a call of ``fn`` with the host out of the way: one warm-up
    call on a side stream, then ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between two events, best of two such windows.
    ``fn`` takes its stream from ``torch.cuda.current_stream()`` when called,
    so that the capture records it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _window_ms(graph.replay, replays) / calls


def timeit(fn, iters: int = 5, captured: CapturedCall | None = None,
           warmup: bool = True) -> tuple[float, str]:
    """(ms a call of ``fn()``, timer): ``"events"`` for ``iters`` calls of
    ``fn`` (the eager route), or replays of ``captured``, ``fn`` captured (the
    graph route), between CUDA events, best of two windows, after one warm-up
    call unless ``warmup`` is False; ``"graph"`` where that read under
    ``GRAPH_MS``, from ``graph_ms``."""
    call = fn if captured is None else captured.replay
    if warmup:
        call()
        torch.cuda.synchronize()
    ms = _window_ms(call, iters)
    if ms < GRAPH_MS:
        return graph_ms(fn), "graph"
    return ms, "events"
