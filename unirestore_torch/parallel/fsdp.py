"""FSDP-style (ZeRO-3) sharding of parameters and optimizer state (the port of
``unirestore_tpu/parallel/fsdp.py``).

The JAX package places each large leaf sharded over the ``data`` axis and
lets GSPMD gather every layer's weights just in time and reduce-scatter the
gradients. The port shards the same leaves by the same rule, but at rest: a
sharded leaf is a ``Shard`` (this rank's block along one axis, with the full
shape and strides it came from). The train step gathers the whole tree at
its start (``gather_tree``), computes on full tensors, reduce-scatters the
mean gradients into the shard layout (``reduce_gradients``) and updates the
shards in place; the full copies are freed when the step returns. Between
steps each rank holds 1/n of every sharded leaf of the trainable masters,
the optimizer's slots and the frozen backbone.

Sharding rule (``fsdp_spec``, as JAX's): each leaf is split along its largest
mesh-divisible axis; leaves under ``min_size`` elements and scalars stay
replicated.

Every collective moves flat buckets, one per dtype and device, in the tree's
leaf order, so every rank calls the same collectives in the same order.
Reductions are sums divided by the world size: the mean of two addends is
then the same whichever rank adds them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

# Leaves below this many elements are replicated (a 128x128 matrix is the
# smallest worth a per-step all-gather).
DEFAULT_MIN_SIZE = 16384


def fsdp_spec(x, n_shards: int, axis_name: str = "data",
              min_size: int = DEFAULT_MIN_SIZE) -> tuple:
    """The JAX ``PartitionSpec`` of ``x`` as a tuple (``unirestore_tpu/parallel/fsdp.py:28-39``):
    ``axis_name`` on the largest ``n_shards``-divisible axis, ``()`` to replicate."""
    shape = tuple(getattr(x, "shape", ()) or ())
    if not shape or math.prod(shape) < max(min_size, 1):
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n_shards == 0 and shape[i] >= n_shards:
            spec = [None] * len(shape)
            spec[i] = axis_name
            return tuple(spec)
    return ()


@dataclasses.dataclass
class Shard:
    """This rank's block of a leaf split into ``parts`` equal blocks along
    ``axis``; ``shape`` and ``stride`` are the full tensor's."""
    local: torch.Tensor
    axis: int
    parts: int
    shape: tuple
    stride: tuple

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def shard_tensor(x: torch.Tensor, axis: int, parts: int, rank: int) -> Shard:
    """Rank ``rank``'s block of ``x`` along ``axis`` (a copy)."""
    k = x.shape[axis] // parts
    return Shard(x.narrow(axis, rank * k, k).clone(), axis, parts, tuple(x.shape),
                 tuple(x.stride()))


def fsdp_shard(mesh, tree, axis_name: str = "data", min_size: int = DEFAULT_MIN_SIZE):
    """``tree`` with each leaf ``fsdp_spec`` splits replaced by this rank's
    ``Shard`` of it (``unirestore_tpu/parallel/fsdp.py:42-51``); the other
    leaves are kept as they are. On a mesh of one the leaves are still
    ``Shard``s (of one block), so the step runs the same collectives."""
    from .. import bridge

    n = mesh.size()
    group = mesh.get_group(axis_name)
    rank = dist.get_rank(group) if group is not None else 0
    out = {}
    for k, x in bridge.flatten(tree).items():
        spec = fsdp_spec(x, n, axis_name, min_size) if isinstance(x, torch.Tensor) else ()
        out[k] = shard_tensor(x, spec.index(axis_name), n, rank) if spec else x
    return bridge.unflatten_like(out, tree)


def sharded_fraction(tree) -> float:
    """Fraction of the tree's elements on sharded placements
    (``unirestore_tpu/parallel/fsdp.py:54-65``): a ``Shard`` of more than one
    block counts with its full size; a mesh of one shards nothing, as in JAX."""
    from .. import bridge

    total = sharded = 0
    for leaf in bridge.flatten(tree).values():
        if isinstance(leaf, Shard):
            total += leaf.numel
            sharded += leaf.numel if leaf.parts > 1 else 0
        else:
            total += math.prod(tuple(getattr(leaf, "shape", ()) or ())) or 1
    return sharded / total if total else 0.0


def _buckets(items):
    """``items`` grouped by (dtype, device), each group in its given order."""
    out = {}
    for item in items:
        t = item[1] if isinstance(item, tuple) else item
        out.setdefault((t.dtype, t.device), []).append(item)
    return out.values()


def coalesced(tensors, fn) -> None:
    """Apply the in-place collective ``fn`` to ``tensors`` through one flat
    buffer per dtype and device, then copy the results back in place."""
    for group in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def _moved(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` with ``axis`` first, contiguous (the layout the flat buffers hold)."""
    return x.movedim(axis, 0).contiguous()


def gather_tree(tree, group):
    """``tree`` with every ``Shard`` replaced by its full tensor, in the
    strides it was sharded from: one ``all_gather_into_tensor`` per dtype and
    device over ``group`` (without a group, a shard is of one block and
    holds the whole tensor). Other leaves are kept as they are."""
    from .. import bridge

    flat = bridge.flatten(tree)
    shards = [(k, v.local, v) for k, v in flat.items() if isinstance(v, Shard)]
    if not shards:
        return tree
    out = dict(flat)
    for bucket in _buckets(shards):
        send = torch.cat([_moved(local, s.axis).reshape(-1) for _, local, s in bucket])
        n = bucket[0][2].parts
        if group is None:
            if n != 1:
                raise ValueError(f"a leaf in {n} shards needs a process group to gather")
            recv = send
        else:
            recv = send.new_empty(n * send.numel())
            dist.all_gather_into_tensor(recv, send, group=group)
        blocks = recv.view(n, -1)
        offset = 0
        for k, local, s in bucket:
            m = local.numel()
            moved = _moved(local, s.axis).shape
            piece = blocks[:, offset:offset + m].reshape(n * moved[0], *moved[1:])
            full = torch.empty_strided(s.shape, s.stride, dtype=local.dtype, device=local.device)
            full.copy_(piece.movedim(0, s.axis))
            out[k] = full
            offset += m
    return bridge.unflatten_like(out, tree)


def reduce_gradients(grads: dict, like: dict, group) -> dict:
    """The mean over ``group``'s ranks of each rank's full gradients
    ``grads`` ({name: tensor}), in ``like``'s layout: reduce-scattered
    into this rank's block where ``like[name]`` is a ``Shard``, all-reduced
    where it is a tensor. Without a group (a shard is then of one block) the
    gradients are returned as they are."""
    if group is None:
        return dict(grads)
    world = dist.get_world_size(group)
    out = {}
    whole = [(k, g) for k, g in grads.items() if not isinstance(like[k], Shard)]
    split = [(k, g) for k, g in grads.items() if isinstance(like[k], Shard)]
    for bucket in _buckets(whole):
        flat = torch.cat([g.reshape(-1) for _, g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(world)
        offset = 0
        for k, g in bucket:
            out[k] = flat[offset:offset + g.numel()].view(g.shape)
            offset += g.numel()
    for bucket in _buckets(split):
        # row r of ``send`` holds rank r's block of every leaf of the bucket
        send = torch.cat([_moved(g, like[k].axis).reshape(world, -1) for k, g in bucket], dim=1)
        recv = send.new_empty(send.shape[1])
        dist.reduce_scatter_tensor(recv, send.reshape(-1), op=dist.ReduceOp.SUM, group=group)
        recv.div_(world)
        offset = 0
        for k, g in bucket:
            local = like[k].local
            moved = _moved(local, like[k].axis).shape
            out[k] = recv[offset:offset + local.numel()].view(moved).movedim(0, like[k].axis)
            offset += local.numel()
    return {k: out[k] for k in grads}


def leaf_norms(tensors: dict, like: dict, group) -> dict:
    """{name: the 2-norm of the whole leaf}: a tensor's own norm, and for a
    ``Shard`` the norm of every rank's block norm (one ``all_gather`` of the
    stacked block norms; replicated leaves are counted once)."""
    norms = {k: torch.linalg.vector_norm(t) for k, t in tensors.items()}
    split = [k for k in tensors if isinstance(like.get(k), Shard)]
    if split and group is not None:
        parts = like[split[0]].parts
        local = torch.stack([norms[k].float() for k in split])
        every = local.new_empty(parts * local.numel())
        dist.all_gather_into_tensor(every, local, group=group)
        whole = torch.linalg.vector_norm(every.view(parts, -1), dim=0)
        for i, k in enumerate(split):
            norms[k] = whole[i].to(norms[k].dtype)
    return norms


def global_norm(tensors: dict, like: dict | None = None, group=None) -> torch.Tensor:
    """The 2-norm over every leaf of ``tensors`` (``optax.global_norm``), with
    the leaves ``like`` marks as ``Shard``s taken whole over ``group``."""
    norms = leaf_norms(tensors, like or {}, group)
    return torch.linalg.vector_norm(torch.stack(list(norms.values())))


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a copy; ``x`` itself without a group)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


__all__ = ["DEFAULT_MIN_SIZE", "Shard", "fsdp_spec", "fsdp_shard", "sharded_fraction",
           "shard_tensor", "coalesced", "gather_tree", "reduce_gradients", "leaf_norms",
           "global_norm", "group_sum"]
