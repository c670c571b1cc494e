"""Parallelism of the port, counterpart of ``vnet_tpu/parallel/``: data
and spatial parallelism over processes (``mesh.py``), halo exchange
(``halo.py``), whole-network spatial partitioning (``spatial.py``) and
minimal tensor parallelism (``tensor.py``). Exports JAX's names and the
port's own."""

from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, active_mesh,
                   all_reduce_mean, batch_rows, batch_sharding,
                   data_parallel, data_parallel_size, launch, make_mesh,
                   make_multislice_mesh, pad_batch_to_multiple, replicated,
                   shard_batch)
from .spatial import spatial_sharded_forward, spatial_sharded_train_step

__all__ = [
    "DATA_AXIS", "SPACE_AXIS", "batch_sharding", "make_mesh",
    "pad_batch_to_multiple", "replicated", "shard_batch",
    "spatial_sharded_forward",
    "spatial_sharded_train_step",
    "Mesh", "active_mesh", "all_reduce_mean", "batch_rows", "data_parallel",
    "data_parallel_size", "launch", "make_multislice_mesh",
]
