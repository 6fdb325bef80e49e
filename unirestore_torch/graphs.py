"""The graph-captured restore: the port's counterpart of the JAX package's compiled restore.

The JAX package never runs its restore op by op: ``bench.py`` jits
``restore_padded``, ``tools/serve.py`` keeps an LRU of 16 compiled programs
keyed by (image shape, task, steps) (``MAX_JITS``), and its DDIM loop is a
``lax.scan`` over a fixed timestep table. ``GraphedRestore`` does the same on
the card with CUDA graphs: the first call for a key captures the whole of
``models/unirestore.py:restore_core`` (resize and pad, encode, the DDIM loop,
decode, crop and resize back) in one ``torch.cuda.CUDAGraph``; later calls
copy their inputs into the graph's buffers and replay it, with no Python and
no kernel-wrapper work per launch. The Python loop over the DDIM steps is
unrolled into the graph, each step's timestep a constant, as ``lax.scan``
over a fixed table compiles it.

Opt-in: ``restore`` stays eager, and eager is the only route on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from collections.abc import Callable, Hashable

import torch

from .device import resolve_device
from .models import unirestore as UR
from .nn import kernels as KN
from .parallel import spatial as SP

MAX_GRAPHS = 16  # the JAX server's MAX_JITS (tools/serve.py)


class GraphCache:
    """At most ``max_graphs`` entries by key; the least recently used goes first.

    ``get(key, make)`` returns the entry of ``key``, calling ``make()`` for a
    missing one after evicting the least recently used entry if the cache is
    full (so that its memory is free for the new one).
    """

    def __init__(self, max_graphs: int = MAX_GRAPHS):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        self._entries: OrderedDict = OrderedDict()

    def get(self, key: Hashable, make: Callable[[], object]):
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key]
        while len(self._entries) >= self.max_graphs:
            self._entries.popitem(last=False)
        entry = self._entries[key] = make()
        return entry

    def keys(self) -> list:
        """Keys from the least to the most recently used."""
        return list(self._entries)

    def values(self) -> list:
        return list(self._entries.values())


@dataclasses.dataclass
class GraphStats:
    """One key's record: captures (more than one after an eviction), the
    kernel launches counted while the last capture ran (by C entry's wrapper
    symbol; the wrappers count only then, a replay runs no wrapper), replays,
    and the seconds of the eager warm-up and of capture plus instantiation."""

    captures: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    replays: int = 0
    warmup_seconds: float = 0.0
    capture_seconds: float = 0.0


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    images: torch.Tensor
    posterior: torch.Tensor
    diffusion: torch.Tensor | None
    out: torch.Tensor


def _launch_counts() -> dict:
    return {kern.symbol: kern.launches for kern in KN.KERNELS}


def _refuse_spatial() -> None:
    SP.refuse("GraphedRestore", "a CUDA graph cannot capture gloo's host collectives, and NCCL "
              "takes one rank a card; restore a rank's slab eagerly with restore(sharding=)")


class GraphedRestore:
    """``restore`` of one model replayed from CUDA graphs, one per key.

    ``GraphedRestore(frozen, trainable, cfg, sched, device)(images, task,
    generator=None, num_inference_steps=None, *, posterior_noise=None,
    diffusion_noise=None)`` returns what ``models/unirestore.py:restore``
    returns for the same arguments.

    - Key: (image shape, dtype, task, steps, cache mode, stride, warmup,
      fused out-projection); at most ``max_graphs`` graphs, the least
      recently used evicted.
    - First call of a key: the inputs are copied into static device buffers
      (images, posterior noise, diffusion noise); one eager ``restore_core``
      on a side stream does the one-time work (kernel builds and loads, the C
      entries' once-per-device attributes and driver entry points, the
      cuBLAS and cuDNN handles); then the whole ``restore_core``, DDIM loop
      included, is captured in one graph.
    - Every call: the inputs are copied into the buffers (images into a
      contiguous one), the graph replays, and a copy of its output is
      returned: the answer never aliases graph memory.
    - Noise: drawn eagerly from ``generator`` into the buffers, posterior
      first (``restore_noise``), or taken from ``posterior_noise`` /
      ``diffusion_noise``. No generator runs inside a capture.
    - Memory: every graph of one instance shares one memory pool. That is
      safe because replays run one at a time and each answer is copied out
      before the next replay; it holds about one restore's peak, not one per
      graph. Calls must not overlap (the server takes a lock).
    - Buffers: the Hopper kernels' TMA tensor maps hold buffer addresses
      that the capture bakes in, as does every captured launch. Replays
      reuse the captured buffers; the parameter tensors must not be
      replaced or freed after a capture (rebinding ``frozen`` / ``trainable``
      leaves needs a new instance).
    - No fallback: a CPU device, or any failure to warm up, capture or
      replay, raises; so does a spatial context (``parallel/spatial.py``).

    ``stats`` maps each key to its ``GraphStats``.
    """

    def __init__(self, frozen, trainable, cfg, sched, device=None, max_graphs: int = MAX_GRAPHS):
        _refuse_spatial()
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"GraphedRestore needs a CUDA device, got {dev}; "
                             "restore eagerly on the CPU")
        self.frozen, self.trainable, self.cfg = frozen, trainable, cfg
        self.sched = sched.to(dev)
        self.device = dev
        self.stats: dict = {}
        self._cache = GraphCache(max_graphs)

    def key(self, shape, dtype, task, steps) -> tuple:
        c = self.cfg
        return (tuple(shape), dtype, task, steps, c.cache_mode, c.cache_stride, c.cache_warmup,
                c.fused_out_attention)

    def __call__(self, images, task, generator=None, num_inference_steps=None, *,
                 posterior_noise=None, diffusion_noise=None):
        _refuse_spatial()
        with torch.inference_mode(), torch.cuda.device(self.device):
            x = torch.as_tensor(images, device=self.device)
            post, diff = UR.restore_noise(self.cfg, UR.padded_shape(x.shape, self.cfg), x.dtype,
                                          generator, self.device, posterior_noise,
                                          diffusion_noise)
            steps = num_inference_steps or self.cfg.num_inference_steps
            key = self.key(x.shape, x.dtype, task, steps)
            g = self._cache.get(key, lambda: self._capture(key, x, post, diff, task, steps))
            for buf, src in ((g.images, x), (g.posterior, post), (g.diffusion, diff)):
                if buf is not None:
                    if src.shape != buf.shape:
                        raise ValueError(f"GraphedRestore: input of shape {tuple(src.shape)} "
                                         f"for a buffer of {tuple(buf.shape)}")
                    buf.copy_(src)
            g.graph.replay()
            self.stats[key].replays += 1
            return g.out.clone()

    def _capture(self, key, x, post, diff, task, steps) -> _Graph:
        def buffer(t):
            return None if t is None else torch.empty(t.shape, dtype=t.dtype, device=self.device)

        images, posterior, diffusion = buffer(x), buffer(post), buffer(diff)

        def run():
            return UR.restore_core(self.frozen, self.trainable, self.cfg, self.sched, images,
                                   task, posterior, diffusion, steps)

        # the buffers hold this call's inputs for the warm-up (the caller copies
        # them again before the replay)
        for buf, src in ((images, x), (posterior, post), (diffusion, diff)):
            if buf is not None:
                buf.copy_(src)
        stats = self.stats.setdefault(key, GraphStats())
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        stats.warmup_seconds = time.perf_counter() - t0

        # a live graph's pool, else a new one: a pool whose graphs are all
        # gone may not be captured into again
        live = self._cache.values()
        pool = live[0].graph.pool() if live else torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool):
            out = run()
        stats.capture_seconds = time.perf_counter() - t0
        stats.launches = {s: n - before[s] for s, n in _launch_counts().items()}
        stats.captures += 1
        return _Graph(graph, images, posterior, diffusion, out)
