"""Parallelism of the port: data parallelism over processes
(``parallel/mesh.py``), counterpart of ``vnet_tpu/parallel/``."""

from .mesh import (Mesh, active_mesh, all_reduce_mean, batch_rows,
                   data_parallel, data_parallel_size, launch, make_mesh,
                   make_multislice_mesh, pad_batch_to_multiple)

__all__ = ["Mesh", "active_mesh", "all_reduce_mean", "batch_rows",
           "data_parallel", "data_parallel_size", "launch", "make_mesh",
           "make_multislice_mesh", "pad_batch_to_multiple"]
