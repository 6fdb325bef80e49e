"""The data mesh and batch placement (the port of ``unirestore_tpu/parallel/mesh.py``).

The JAX package's data parallelism is a 1-D ``data`` mesh: batches sharded on
it, parameters replicated, the gradient all-reduce inserted by XLA. The
port's mesh is a 1-D ``DeviceMesh`` named ``("data",)`` over the process
group's ranks, one card (or CPU process) each; the step reduces the gradients
itself (``train/steps.py``). Without a process group the mesh is the trivial
one of this process alone.

The 2-D (data, spatial) mesh (``make_mesh_2d``, ``spatial_batch_sharding``,
JAX ``mesh.py:25-43``) is for spatially sharded inference: each rank holds a
block of the batch's rows and a slab of the image's height, and
``models/unirestore.py:restore_padded(..., sharding=)`` runs with the
partition context of ``spatial.py``, which does by hand the halo exchanges,
partial reductions and attention gathers that GSPMD inserts for the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_local_rows


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The mesh of one process without a process group: each named axis of
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


def make_mesh_2d(data: int, spatial: int):
    """A 2-D mesh named ``("data", "spatial")`` over every rank of the process
    group (``unirestore_tpu/parallel/mesh.py:25-37``): rank ``d * spatial + s``
    holds data block ``d`` and height slab ``s``; ``cuda`` under NCCL, ``cpu``
    under gloo (which also takes CUDA tensors, for ranks that share one card).
    Raises ``ValueError``, as the JAX function does, unless ``data * spatial``
    is the number of ranks (1 without a process group, which gives a
    ``LocalMesh``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * spatial != world:
        raise ValueError(f"{data}x{spatial} mesh needs {data * spatial} "
                         f"devices, have {world}")
    if not dist.is_initialized():
        return LocalMesh(("data", "spatial"))
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, spatial), mesh_dim_names=("data", "spatial"))


def _block(n: int, index: int, parts: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by {parts}")
    per = n // parts
    return slice(index * per, (index + 1) * per)


@dataclasses.dataclass
class SpatialBatchSharding:
    """The counterpart of ``NamedSharding(mesh, P('data', 'spatial'))`` for NHWC
    batches (``unirestore_tpu/parallel/mesh.py:40-42``): batch rows on
    ``data``, image height on ``spatial``. ``local`` cuts this rank's block
    out of a global batch, ``assemble`` puts the ranks' blocks back together
    (the counterpart of ``np.asarray`` on a sharded ``jax.Array``).
    ``timed`` makes each restore's context time its collectives with the card
    synchronised (``SpatialContext``); ``last_context`` is the context of the
    last restore run with this sharding."""
    mesh: object
    timed: bool = False
    last_context: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> tuple:
        """(data, spatial): ranks along each axis."""
        return self.mesh.size(0), self.mesh.size(1)

    @property
    def coordinate(self) -> tuple:
        """(data index, spatial index) of this rank."""
        if isinstance(self.mesh, LocalMesh):
            return 0, 0
        return self.mesh.get_local_rank("data"), self.mesh.get_local_rank("spatial")

    def global_shape(self, local_shape) -> tuple:
        (d, s), (b, h) = self.shape, local_shape[:2]
        return (b * d, h * s) + tuple(local_shape[2:])

    def local(self, x):
        """This rank's contiguous rows (over ``data``) and slab of height (over
        ``spatial``) of a global NHWC array or tensor."""
        (d, s), (i, j) = self.shape, self.coordinate
        return x[_block(x.shape[0], i, d, "global batch"),
                 _block(x.shape[1], j, s, "image height")]

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from every rank's block ``x`` (one all-gather over
        the mesh's ranks, which it must hold in rank order, as ``make_mesh_2d``
        builds it)."""
        (d, s) = self.shape
        if d * s == 1:
            return x
        x = x.contiguous()
        out = torch.empty((d * s * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x)
        b, h = x.shape[:2]
        out = out.reshape((d, s) + tuple(x.shape)).transpose(1, 2)
        return out.reshape((d * b, s * h) + tuple(x.shape[2:]))

    def context(self, height: int):
        """The partition context of a restore of images ``height`` rows high
        (``parallel/spatial.py``); None when the spatial axis has one rank,
        whose slab is then the whole image."""
        if self.shape[1] == 1:
            return None
        from .spatial import SpatialContext

        self.last_context = SpatialContext(self.mesh.get_group("spatial"), self.coordinate[1],
                                           self.shape[1], height, timed=self.timed)
        return self.last_context


def spatial_batch_sharding(mesh, timed: bool = False) -> SpatialBatchSharding:
    """Batch on 'data', image height on 'spatial' (NHWC axis 1)."""
    return SpatialBatchSharding(mesh, timed)


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


__all__ = ["LocalMesh", "SpatialBatchSharding", "make_mesh", "make_mesh_2d", "replicate",
           "shard_batch", "spatial_batch_sharding", "unreplicate", "local_batch_size"]
