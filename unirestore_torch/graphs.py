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

``GraphedTrainStep`` is the counterpart of the JAX package's compiled train
step (the per-part jits of its split step, ``unirestore_tpu/train/
steps.py:286-371``): the parts of ``train/steps.py:make_train_step``
(``make_step_parts``) captured in one graph, and the optimizer tail
(``optimizer_tail``) in one graph a form, accumulating or applying, with the
update's scalars in a static buffer. It gives the eager step's bits, for
every task of every stage, the detectors' ``det`` included.

``GraphedCall`` is the counterpart of ``jax.jit(fn)`` for a network of fixed
parameters: the validation networks the JAX package jits (the probe zoos,
the stage-2 probes, LPIPS, FID's Inception, the NR suite) replayed from one
graph per input shape.

Opt-in: ``restore``, the step and the networks stay eager, and eager is the
only route on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from collections.abc import Callable, Hashable

import torch
import torch.distributed as dist

from . import bridge
from .device import resolve_device
from .evalx.evaluators import host_tensor
from .models import unirestore as UR
from .nn import kernels as KN
from .parallel import fsdp as FSDP
from .parallel import spatial as SP
from .train import steps as TS

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


def refuse_graph_route(what: str, device=None, *, group=None, trees=()) -> torch.device:
    """The CUDA device of a graph route (``GraphedTrainStep``, the engine's
    graph-captured restores, ``GraphedCall``), or an error: in a spatial
    context, under a process group (a CUDA graph cannot capture gloo's host
    collectives, and NCCL takes one rank a card), with FSDP ``Shard`` leaves
    in ``trees``, or off a CUDA device. There is no eager fallback."""
    SP.refuse(what, "the spatial mesh runs its collectives on the host, which a CUDA graph "
              "cannot capture")
    if group is not None or (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"{what} does not run under a process group: a CUDA graph cannot "
                         "capture gloo's host collectives, and NCCL takes one rank a card; "
                         "train data-parallel eagerly")
    for tree in trees:
        if any(isinstance(v, FSDP.Shard) for v in bridge.flatten(tree).values()):
            raise ValueError(f"{what} does not take FSDP shards: every step gathers them "
                             "over the process group; train sharded eagerly")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"{what} needs a CUDA device, got {dev}; run it eagerly on the CPU")
    return dev


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


# eager iterations before a capture: autograd, cuBLAS and cuDNN set up their
# handles and workspaces lazily, on the first calls
TRAIN_WARMUP_STEPS = 2


def _train_counts() -> dict:
    """{C entry's wrapper symbol: (forward launches, remat recompute launches,
    backward calls)} so far."""
    return {kern.symbol: (kern.launches - kern.recompute_launches, kern.recompute_launches,
                          kern.backwards) for kern in KN.KERNELS}


def _state_tensors(opt_state) -> list:
    return [t for sub in opt_state.values() if isinstance(sub, dict) for t in sub.values()]


def _bound(trainable, opt_state) -> tuple:
    """The addresses a captured step reads and writes: every trainable leaf
    and every optimizer slot."""
    return tuple(t.data_ptr() for t in (*bridge.flatten(trainable).values(),
                                        *_state_tensors(opt_state)))


def _copies(stage, trainable, opt_state) -> tuple:
    """``trainable`` with its trained leaves cloned, and a copy of ``opt_state``:
    what the warm-up steps move in place of the real ones."""
    trained = TS.trained_leaves(stage, trainable)
    tr = bridge.unflatten_like({k: trained[k].clone() if k in trained else v
                                for k, v in bridge.flatten(trainable).items()}, trainable)
    state = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
             for k, v in opt_state.items()}
    return tr, state


class ScalarBuffer:
    """A static fp32 buffer of one optimizer-tail form's per-update scalars
    (``Optimizer.advance``'s, in sorted key order); ``views`` are its 0-dim
    entries, which the tail reads in place of the host floats."""

    def __init__(self, host: dict, device):
        self.keys = tuple(sorted(host))
        self.buffer = torch.zeros(len(self.keys), dtype=torch.float32, device=device)
        self.views = {k: self.buffer[i] for i, k in enumerate(self.keys)}

    def fill(self, host: dict) -> None:
        """Copy a call's host floats in: to a card from pinned memory, without a
        host wait (the pinned block is not reused before the copy has run)."""
        if tuple(sorted(host)) != self.keys:
            raise ValueError(f"per-update scalars {sorted(host)} for a buffer of {self.keys}")
        values = torch.tensor([float(host[k]) for k in self.keys], dtype=torch.float32)
        if self.buffer.is_cuda:
            values = values.pin_memory()
        self.buffer.copy_(values, non_blocking=True)


@dataclasses.dataclass
class _Tail:
    graph: torch.cuda.CUDAGraph
    scalars: ScalarBuffer
    grad_norm: torch.Tensor


@dataclasses.dataclass
class _StepGraph:
    graph: torch.cuda.CUDAGraph  # the parts
    batch: dict
    noise: TS.StepNoise
    logs: dict
    tails: dict  # by whether the form applies the update
    bound: tuple


def _noise_fields(noise) -> tuple:
    return noise.hq, noise.lq, noise.diffusion, noise.timesteps


def _flat_batch(batch: dict, prefix: tuple = ()) -> dict:
    """{path: tensor} of a batch in sorted order, a nested dict (a ``det``
    batch's padded ``gt``: boxes, labels, mask) flattened to its paths."""
    out = {}
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            out.update(_flat_batch(v, (*prefix, k)))
        elif isinstance(v, torch.Tensor):
            out[(*prefix, k)] = v
        else:
            raise TypeError(f"GraphedTrainStep: batch entry {'.'.join((*prefix, k))!r} is "
                            "not a tensor")
    return out


def _nest(flat: dict) -> dict:
    """The batch of ``_flat_batch``'s paths."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


class GraphedTrainStep:
    """``make_train_step``'s step of one (stage, task), replayed from CUDA graphs.

    ``GraphedTrainStep(frozen, cfg, sched, stage, tx, task, te_loss_fn=None,
    remat=True, stop_after=None, device=None, group=None, cache=None)`` is
    called as the step is, ``step(trainable, opt_state, batch, noise) ->
    (trainable, opt_state, logs)``, and gives the same bits; ``task`` names
    its task.

    - Key: the task, the shape and dtype of every batch entry (each of a
      ``det`` batch's nested ``gt`` dict: boxes, labels and mask padded to
      ``train/engine.py:MAX_BOXES``) and ``stop_after``. An entry holds the
      parts' graph and one graph for each form of the optimizer tail
      (accumulating, applying; only the applying one without accumulation,
      none after a ``stop_after``). Steps that
      share ``cache`` (a ``GraphCache``; the trainer passes one to the step
      of each task) keep their graphs in one LRU and one memory pool; the
      key starts with the task, so two tasks' steps never share a key.
    - First call of a key: the batch and noise are copied into static device
      buffers; ``TRAIN_WARMUP_STEPS`` eager steps on a side stream, from
      copies of the trained leaves and of the optimizer state (the real ones
      do not move), run the parts and every tail form; then the parts
      (``steps.make_step_parts``: forwards, ``torch.autograd.grad`` and the
      remat recomputes) are captured in one graph and each tail form
      (``steps.optimizer_tail``) in its own, all in one pool.
    - Every call: the batch and the noise (drawn eagerly by the caller) are
      copied into the buffers, the parts replay; the host's ``tx.advance``
      moves ``mini_step`` and ``count`` (host integers) and gives the form
      and its scalars, which are copied into the form's static buffer, and
      that form replays. The logs returned are clones: the next replay
      overwrites the graph's outputs.
    - The trained leaves and the optimizer slots are updated in place, so
      their addresses stay those the capture baked in. A call with another
      trainable tree or optimizer state than the captured one (a resume,
      ``load_subtree``) raises: make a new instance. ``frozen`` must not be
      rebound or freed either.
    - No fallback: a CPU device, a process group, FSDP shards and a spatial
      context are refused (``refuse_graph_route``); a failure to warm up,
      capture or replay raises. The detectors' losses capture as they are:
      their anchors, tables and Faster R-CNN's sampling draws are device
      constants that the warm-up makes (``tasks/retinanet.py:on_device``,
      ``tasks/fasterrcnn.py:loss_uniforms``).

    ``stats`` maps each key to its ``GraphStats``; its ``launches`` are
    (forward, remat recompute, backward) by kernel, counted while the parts
    were captured. A replay runs no kernel wrapper.
    """

    def __init__(self, frozen, cfg, sched, stage, tx, task: str, te_loss_fn=None,
                 remat: bool = True, stop_after: str | None = None, device=None, group=None,
                 cache: GraphCache | None = None):
        self.device = refuse_graph_route("GraphedTrainStep", device, group=group,
                                         trees=(frozen,))
        cfg = TS.with_remat(cfg) if remat else cfg
        self.parts = TS.make_step_parts(cfg, sched.to(self.device), stage, task, te_loss_fn,
                                        stop_after)
        self.frozen, self.stage, self.tx = frozen, stage, tx
        self.task, self.stop_after = task, stop_after
        self.stats: dict = {}
        self._cache = GraphCache() if cache is None else cache

    def key(self, batch: dict) -> tuple:
        return (self.task, tuple((path, tuple(v.shape), v.dtype)
                                 for path, v in _flat_batch(batch).items()), self.stop_after)

    def _forms(self) -> tuple:
        if self.stop_after is not None:
            return ()
        return (False, True) if self.tx.accum_iter > 1 else (True,)

    def _form_scalars(self, opt_state, applies: bool) -> dict:
        """The host scalars of a call of that form at the state's count."""
        n = self.tx.accum_iter - 1 if applies else 0
        return self.tx.advance({"count": opt_state["count"], "mini_step": n})[1]

    def __call__(self, trainable, opt_state, batch, noise):
        refuse_graph_route("GraphedTrainStep", self.device, trees=(trainable,))
        with torch.cuda.device(self.device):
            key = self.key(batch)
            g = self._cache.get(key, lambda: self._capture(key, trainable, opt_state, batch,
                                                           noise))
            if g.bound != _bound(trainable, opt_state):
                raise ValueError("GraphedTrainStep: the trainable tree or the optimizer state "
                                 "is not the one captured (its addresses are baked into the "
                                 "graphs); make a new instance for a rebound tree")
            flat = _flat_batch(batch)
            for buf, src in (*((g.batch[k], flat[k]) for k in g.batch),
                             *zip(_noise_fields(g.noise), _noise_fields(noise))):
                if src.shape != buf.shape:
                    raise ValueError(f"GraphedTrainStep: input of shape {tuple(src.shape)} for "
                                     f"a buffer of {tuple(buf.shape)}")
                buf.copy_(src)
            g.graph.replay()
            self.stats[key].replays += 1
            logs = {k: v.clone() for k, v in g.logs.items()}
            if not g.tails:
                return trainable, opt_state, logs
            applies, scalars = self.tx.advance(opt_state)
            tail = g.tails[applies]
            tail.scalars.fill(scalars)
            tail.graph.replay()
            logs["train/grad_norm"] = tail.grad_norm.clone()
            return trainable, opt_state, logs

    def _capture(self, key, trainable, opt_state, batch, noise) -> _StepGraph:
        stats = self.stats.setdefault(key, GraphStats())
        flat = _flat_batch(batch)
        bufs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in flat.items()}
        nz = TS.StepNoise(*(torch.empty(x.shape, dtype=x.dtype, device=self.device)
                            for x in _noise_fields(noise)))
        # the buffers hold this call's inputs for the warm-up (the call copies
        # them again before the replay)
        for buf, src in (*((bufs[k], flat[k]) for k in bufs),
                         *zip(_noise_fields(nz), _noise_fields(noise))):
            buf.copy_(src)
        nested = _nest(bufs)  # the batch the parts read: a det batch's gt a dict again
        scalars = {applies: ScalarBuffer(self._form_scalars(opt_state, applies), self.device)
                   for applies in self._forms()}

        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            tr, state = _copies(self.stage, trainable, opt_state)
            like = TS.trained_leaves(self.stage, tr)
            for _ in range(TRAIN_WARMUP_STEPS):
                logs, grads = self.parts(self.frozen, tr, nested, nz)
                for applies, sc in scalars.items():
                    sc.fill(self._form_scalars(state, applies))
                    TS.optimizer_tail(self.tx, state, like, grads, (applies, sc.views))
            del tr, state, like, logs, grads
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        stats.warmup_seconds = time.perf_counter() - t0

        # a live graph's pool, else a new one: a pool whose graphs are all
        # gone may not be captured into again
        live = self._cache.values()
        pool = live[0].graph.pool() if live else torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _train_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool):
            logs, grads = self.parts(self.frozen, trainable, nested, nz)
        stats.launches = {s: tuple(a - b for a, b in zip(n, before[s]))
                          for s, n in _train_counts().items()}
        tails = {}
        like = TS.trained_leaves(self.stage, trainable)
        for applies, sc in scalars.items():
            tail = torch.cuda.CUDAGraph()
            with torch.cuda.graph(tail, pool=graph.pool()):
                grad_norm = TS.optimizer_tail(self.tx, opt_state, like, grads,
                                              (applies, sc.views))
            tails[applies] = _Tail(tail, sc, grad_norm)
        stats.capture_seconds = time.perf_counter() - t0
        stats.captures += 1
        return _StepGraph(graph, bufs, nz, logs, tails, _bound(trainable, opt_state))


@dataclasses.dataclass
class _CallGraph:
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    out: torch.Tensor


class GraphedCall:
    """``fn`` of a network of fixed parameters, replayed from CUDA graphs: the
    port's counterpart of ``jax.jit(fn)``, with which the JAX package runs its
    validation networks (``unirestore_tpu/tasks/classifier_zoo.py:76-93``,
    ``seg_zoo.py:43-60``, ``config.py:213-227``, ``evalx/lpips.py:92``,
    ``evalx/inception.py:198``, ``evalx/nr_suite.py:64-96``).

    ``GraphedCall(fn, device=None)(*arrays)`` returns
    ``fn(*inputs)`` as a tensor on the host, where ``inputs`` are the arrays
    (numpy, any dtype) as fp32 tensors on the card; ``fn`` runs under
    ``torch.inference_mode`` and returns one tensor.

    - Key: the shape and dtype of every input; one graph per key, at most
      ``MAX_GRAPHS``, the least recently used evicted, as ``jax.jit`` keeps a
      program per shape (the seg evaluator's three TTA scales are three).
    - First call of a key: static input buffers; one eager ``fn`` on a side
      stream does the one-time work (cuBLAS and cuDNN handles, the constants
      the networks keep per shape and device: resize taps, position indices,
      normalisation statistics); then ``fn`` is captured in one graph.
    - Every call: each array is copied to pinned memory in the eager
      route's format (``evalx.evaluators.host_tensor``) and from there into
      its buffer (``copy_``, without a host wait), the graph replays, and its
      output is read back: the one point of a call where the host waits.
    - Memory: the graphs of one instance share one memory pool. That is safe
      because replays run one at a time and each output is read back before
      the next replay.
    - No fallback: a CPU device, a process group and a spatial context are
      refused (``refuse_graph_route``); a failure to warm up, capture or
      replay raises.

    ``stats`` maps each key to its ``GraphStats`` (the validation networks
    launch none of the repo's kernels).
    """

    def __init__(self, fn, device=None):
        self.device = refuse_graph_route("GraphedCall", device)
        self.fn = fn
        self.stats: dict = {}
        self._cache = GraphCache(MAX_GRAPHS)

    @staticmethod
    def key(inputs) -> tuple:
        return tuple((tuple(x.shape), x.dtype) for x in inputs)

    def __call__(self, *arrays) -> torch.Tensor:
        refuse_graph_route("GraphedCall", self.device)
        with torch.inference_mode(), torch.cuda.device(self.device):
            host = [host_tensor(a, self.device) for a in arrays]
            key = self.key(host)
            g = self._cache.get(key, lambda: self._capture(key, host))
            for buf, x in zip(g.inputs, host):
                buf.copy_(x, non_blocking=True)
            g.graph.replay()
            self.stats[key].replays += 1
            return g.out.cpu()

    def _capture(self, key, host) -> _CallGraph:
        stats = self.stats.setdefault(key, GraphStats())
        inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in host)
        # the buffers hold this call's inputs for the warm-up (the call copies
        # them again before the replay)
        for buf, x in zip(inputs, host):
            buf.copy_(x, non_blocking=True)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.fn(*inputs)
        current.wait_stream(side)
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
            out = self.fn(*inputs)
        stats.capture_seconds = time.perf_counter() - t0
        stats.launches = {s: n - before[s] for s, n in _launch_counts().items()}
        stats.captures += 1
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"GraphedCall: fn returned {type(out).__name__}, not one tensor")
        return _CallGraph(graph, inputs, out)
