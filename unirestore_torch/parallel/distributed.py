"""Multi-process runtime initialisation (the port of
``unirestore_tpu/parallel/distributed.py``).

The JAX package starts ``jax.distributed`` so that ``jax.devices()`` spans
every host; the port starts a ``torch.distributed`` process group, one
process per card (``torchrun``), and reduces gradients over it (NCCL on the
card, gloo on the CPU). As in the JAX package, only the host side of batch
feeding is per process: the loaders are deterministic per global step, so
every process materialises the same global batch and keeps its contiguous
row block (``process_local_rows``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _torchrun_env() -> bool:
    """torchrun's rendezvous variables, the counterpart of ``JAX_COORDINATOR_ADDRESS``."""
    return bool(os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"))


def init_distributed(force: bool = False, *, backend: str | None = None, device=None) -> bool:
    """Start the process group for multi-process training
    (``unirestore_tpu/parallel/distributed.py:29-65``).

    Gated as the JAX function is: it runs when ``force`` is true, when
    ``UNIRESTORE_DISTRIBUTED=1``, when torchrun's environment is set
    (``MASTER_ADDR`` and ``WORLD_SIZE``; read by the ``env://`` rendezvous), or
    when ``COORDINATOR_ADDRESS`` is set, in which case it and
    ``PROCESS_ID`` / ``NUM_PROCESSES`` are passed as a ``tcp://`` address, the
    rank and the world size. With none of these it returns False and touches
    nothing.

    ``backend`` defaults to ``nccl`` when ``device`` (default: the CUDA
    device ``LOCAL_RANK`` names) is a CUDA device and ``gloo`` on the CPU;
    naming it runs, e.g., gloo between processes that share one card. On a
    CUDA device the process's current device is set first. Returns True when
    a process group was started (or already runs).
    """
    addr = os.environ.get("COORDINATOR_ADDRESS")
    want = (force or os.environ.get("UNIRESTORE_DISTRIBUTED") == "1" or _torchrun_env()
            or addr)
    if not want:
        return False
    if dist.is_initialized():
        return True
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if addr and not _torchrun_env():
        kw = {"init_method": f"tcp://{addr}", "rank": int(os.environ.get("PROCESS_ID", 0)),
              "world_size": int(os.environ.get("NUM_PROCESSES", 1))}
    elif not _torchrun_env():
        raise RuntimeError("init_distributed: no rendezvous; run under torchrun "
                           "(MASTER_ADDR, WORLD_SIZE, RANK) or set COORDINATOR_ADDRESS, "
                           "PROCESS_ID and NUM_PROCESSES")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        kw["device_id"] = dev  # the communicator's card, for collectives and barriers
    dist.init_process_group(backend, **kw)
    print(f"[distributed] process {rank()}/{world_size()}, 1 local / {world_size()} global "
          f"devices ({dist.get_backend()} on {dev})", flush=True)
    return True


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_rows(n_rows: int) -> slice:
    """This process's slice of a leading-axis-sharded global batch
    (``unirestore_tpu/parallel/distributed.py:68-82``): contiguous equal row
    blocks in rank order; the whole batch without a process group."""
    n_proc = world_size()
    if n_rows % n_proc:
        raise ValueError(f"global batch {n_rows} not divisible by {n_proc} processes")
    per = n_rows // n_proc
    lo = rank() * per
    return slice(lo, lo + per)


__all__ = ["init_distributed", "process_local_rows", "rank", "world_size"]
