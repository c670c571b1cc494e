"""Host-side 3D data pipeline of the port: the transform registry, NIfTI
case datasets and the prefetching batch loader.

The port's own copy of the 3D part of ``vnet_tpu/data`` (``registry``,
``rand``, ``transforms3d``, ``dataset3d``, ``loader``), equal in behaviour
(``tests/test_torch_data.py``). The 2D datasets and transforms and the
on-device augmentation are not ported yet (ROADMAP.md).
"""

from . import transforms3d  # noqa: F401  (populate registry)
from .dataset3d import NiftiDataset3D, list_cases, remap_label
from .loader import BatchLoader
from .registry import (build_pipeline, build_transform, build_transform_list,
                       register_transform, transform_names)

__all__ = [
    "NiftiDataset3D", "BatchLoader", "list_cases", "remap_label",
    "build_pipeline", "build_transform", "build_transform_list",
    "register_transform", "transform_names",
]
