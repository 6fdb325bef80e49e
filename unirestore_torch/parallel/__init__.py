"""Data-parallel and FSDP training over ``torch.distributed`` (the port of
``unirestore_tpu/parallel/``; the 2-D spatial mesh is not ported, see ``mesh.py``)."""

from .distributed import init_distributed, process_local_rows  # noqa: F401
from .fsdp import fsdp_shard, fsdp_spec, sharded_fraction  # noqa: F401
from .mesh import make_mesh, replicate, shard_batch, unreplicate  # noqa: F401
