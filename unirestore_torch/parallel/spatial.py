"""The partition context of a spatially sharded restore: the port's hand-written
counterpart of what GSPMD inserts under the JAX package's 2-D (data, spatial)
mesh (``unirestore_tpu/parallel/mesh.py:25-43``).

Under ``P('data', 'spatial')`` each rank holds a contiguous block of the
batch's rows and a contiguous slab of the image's height (NHWC axis 1). GSPMD
partitions every op of the jitted restore over that layout by itself; the port
has no partitioner, so each primitive that reads across rows consults the
context set here and does the exchange by hand:

- 3x3 and stride-2 convolutions exchange one halo row with each neighbour
  (``halo``: one ``all_gather_into_tensor`` of every rank's first and last
  row; the image's own edges get zero rows);
- GroupNorm, InstanceNorm and global average pooling reduce their partial
  sums over the spatial group (``all_reduce``, SUM);
- self-attention gathers its tokens to the global sequence (``gather_rows``),
  runs whole, and keeps this rank's rows (``local_rows``), as GSPMD does with
  a ``pallas_call`` it cannot partition.

Per-pixel layers (1x1 convolutions, ``linear``, ``layer_norm``, the
upsampling and gating ops) need nothing. The context is set only by
``models/unirestore.py:restore_padded`` with a ``sharding`` whose spatial axis
has more than one rank, for the length of that restore: with no context set
every function computes what it computes without this module. A primitive that
spans the image and has no partitioned form raises under the context
(``refuse``) rather than run on the local slab as if it were the whole image;
collective failures are not caught.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

COLLECTIVES = ("halo", "all_reduce", "all_gather")


@dataclasses.dataclass
class SpatialContext:
    """The spatial process ``group``, this rank's ``index`` along it, the
    number of ranks ``size``, and the global ``height`` of the images being
    restored. ``counts`` tallies the collectives issued by kind (``COLLECTIVES``)
    and ``seconds`` their host time; with ``timed`` the card is synchronised
    before and after each one, so that ``seconds`` reads the collectives alone
    (off by default: it serialises the host with the card)."""
    group: object
    index: int
    size: int
    height: int
    timed: bool = False
    counts: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    seconds: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    def first_row(self, local_rows: int) -> int:
        """The global index of this rank's first row of a map ``local_rows`` high."""
        return self.index * local_rows


# The context of the restore in progress. One for the process, as
# ``nn/attention.py``'s fused out-projection switch: a process restores one
# sharded batch at a time.
_CURRENT: SpatialContext | None = None


def current() -> SpatialContext | None:
    """The context of the spatially sharded restore in progress, else None."""
    return _CURRENT


@contextlib.contextmanager
def partition(ctx: SpatialContext):
    """Within the block, the partition-aware primitives treat their inputs as
    this rank's slab of ``ctx``'s images."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("partition: a spatial context is already set")
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = None


def refuse(what: str, why: str) -> None:
    """Raise if a spatial context is set: ``what`` spans the image (``why``)
    and has no partitioned form."""
    if _CURRENT is not None:
        raise NotImplementedError(f"{what} does not run on height-sharded images: {why}")


@contextlib.contextmanager
def _collective(ctx: SpatialContext, kind: str, like: torch.Tensor):
    if ctx.timed and like.is_cuda:
        torch.cuda.synchronize(like.device)
    t0 = time.perf_counter()
    yield
    if ctx.timed and like.is_cuda:
        torch.cuda.synchronize(like.device)
    ctx.counts[kind] += 1
    ctx.seconds[kind] += time.perf_counter() - t0


def _gather(ctx: SpatialContext, x: torch.Tensor, kind: str) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order."""
    x = x.contiguous()
    out = torch.empty((ctx.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _collective(ctx, kind, x):
        dist.all_gather_into_tensor(out, x, group=ctx.group)
    return out.view((ctx.size,) + tuple(x.shape))


def halo(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """NHWC ``x`` with ``above`` rows of the previous rank's slab on top and
    ``below`` rows of the next rank's underneath (each 0 or 1); zero rows
    beyond the image's first and last row, as a convolution's zero padding."""
    ctx = _CURRENT
    if above not in (0, 1) or below not in (0, 1):
        raise ValueError(f"halo: one row at most on each side, got {above} / {below}")
    if not (above or below):
        return x
    edges = _gather(ctx, torch.stack([x[:, 0], x[:, -1]]), "halo")  # (size, 2, B, W, C)
    parts = []
    if above:
        top = edges[ctx.index - 1, 1] if ctx.index > 0 else torch.zeros_like(x[:, 0])
        parts.append(top[:, None])
    parts.append(x)
    if below:
        bottom = edges[ctx.index + 1, 0] if ctx.index < ctx.size - 1 else torch.zeros_like(x[:, 0])
        parts.append(bottom[:, None])
    return torch.cat(parts, dim=1)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the spatial group (``t`` is overwritten and returned)."""
    ctx = _CURRENT
    t = t.contiguous()
    with _collective(ctx, "all_reduce", t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
    return t


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, T_local, ...) tokens of this rank's rows -> the global (B, size *
    T_local, ...): a rank's tokens are a contiguous block of the image's
    row-major tokens, and the ranks hold the blocks in order."""
    ctx = _CURRENT
    g = _gather(ctx, x, "all_gather")  # (size, B, T_local, ...)
    return g.transpose(0, 1).reshape((x.shape[0], ctx.size * x.shape[1]) + tuple(x.shape[2:]))


def local_rows(y: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's block of ``n`` entries along axis 1 of a global ``y``."""
    lo = _CURRENT.first_row(n)
    return y[:, lo:lo + n]


__all__ = ["COLLECTIVES", "SpatialContext", "all_reduce_sum", "current", "gather_rows",
           "halo", "local_rows", "partition", "refuse"]
