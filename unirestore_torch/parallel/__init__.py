"""Data-parallel and FSDP training and the 2-D (data, spatial) mesh over
``torch.distributed`` (the port of ``unirestore_tpu/parallel/``)."""

from .distributed import init_distributed, process_local_rows  # noqa: F401
from .fsdp import fsdp_shard, fsdp_spec, sharded_fraction  # noqa: F401
from .mesh import (make_mesh, make_mesh_2d, replicate, shard_batch,  # noqa: F401
                   spatial_batch_sharding, unreplicate)
