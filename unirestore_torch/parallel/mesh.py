"""The data mesh and batch placement (the port of ``unirestore_tpu/parallel/mesh.py``).

The JAX package's data parallelism is a 1-D ``data`` mesh: batches sharded on
it, parameters replicated, the gradient all-reduce inserted by XLA. The
port's mesh is a 1-D ``DeviceMesh`` named ``("data",)`` over the process
group's ranks, one card (or CPU process) each; the step reduces the gradients
itself (``train/steps.py``). Without a process group the mesh is the trivial
one of this process alone.

Not ported: the 2-D (data, spatial) mesh (``make_mesh_2d``,
``spatial_batch_sharding``, JAX ``mesh.py:25-43``). No entry point reaches
it, and in JAX GSPMD writes its convolution halo exchanges and GroupNorm
partial reductions; the port has no partitioner to write them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_local_rows


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The mesh of one process without a process group: a ``data`` axis of
    size 1 and no group to reduce over."""
    mesh_dim_names: tuple = ("data",)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None


def make_mesh(axis_name: str = "data"):
    """A 1-D mesh named ``(axis_name,)`` over every rank of the process group
    (``unirestore_tpu/parallel/mesh.py:21-23``), of device type ``cuda`` under
    NCCL and ``cpu`` under gloo; ``LocalMesh`` without a group. The step
    reduces over ``mesh.get_group(axis_name)``."""
    if not dist.is_initialized():
        return LocalMesh((axis_name,))
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def _map(fn, tree):
    """``fn`` over every array of a nested dict; other values pass through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def shard_batch(mesh, batch, axis_name: str = "data"):
    """This process's rows of a host batch (``unirestore_tpu/parallel/mesh.py:62-78``):
    every process holds the same global batch and keeps its contiguous block
    (``process_local_rows``) of each array, those of a nested dict (the
    padded detection targets) too. Other entries (the task name, file names)
    pass through. Without a process group the batch is returned whole."""
    if mesh.size() == 1:
        return batch
    return _map(lambda x: x[process_local_rows(x.shape[0])], batch)


def _leaves(tree):
    from .. import bridge

    return [v for v in bridge.flatten(tree).values() if isinstance(v, torch.Tensor)]


def replicate(mesh, tree):
    """Make every rank's copy of ``tree`` rank 0's (``unirestore_tpu/parallel/mesh.py:81-84``):
    each tensor leaf is overwritten in place by a broadcast from rank 0, in
    flat buckets of one dtype. Returns ``tree``."""
    group = mesh.get_group(mesh.mesh_dim_names[0])
    if group is None:
        return tree
    from .fsdp import coalesced

    coalesced(_leaves(tree), lambda flat: dist.broadcast(flat, src=0, group=group))
    return tree


def unreplicate(tree):
    """One copy of a replicated tree as numpy arrays
    (``unirestore_tpu/parallel/mesh.py:87-89``)."""
    from .. import bridge

    return bridge.unflatten_like({k: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                  else np.asarray(x) for k, x in bridge.flatten(tree).items()},
                                 tree)


def local_batch_size(global_batch: int, mesh, axis_name: str = "data") -> int:
    """The rows each rank takes of ``global_batch`` (``unirestore_tpu/parallel/mesh.py:92-97``)."""
    n = mesh.size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{axis_name} axis size {n}")
    return global_batch // n


__all__ = ["LocalMesh", "make_mesh", "replicate", "shard_batch", "unreplicate",
           "local_batch_size"]
