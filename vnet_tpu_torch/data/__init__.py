"""Host-side data pipeline of the port: the transform registry, NIfTI case
and slice datasets and the prefetching batch loader.

The port's own copy of ``vnet_tpu/data`` (``registry``, ``rand``,
``transforms3d``, ``transforms2d``, ``dataset3d``, ``dataset2d``,
``distance``, ``loader``), equal in behaviour (``tests/test_torch_data.py``),
and the on-device augmentation (``device_aug``, on tensors).
``build_pipeline(cfg, phase, 2)`` returns ``{"3D": [...], "2D": [...]}``,
the chains ``NiftiDataset2D`` takes.
"""

from . import transforms2d, transforms3d  # noqa: F401  (populate registry)
from .dataset2d import NiftiDataset2D
from .dataset3d import NiftiDataset3D, list_cases, remap_label
from .loader import BatchLoader
from .registry import (build_pipeline, build_transform, build_transform_list,
                       register_transform, transform_names)

__all__ = [
    "NiftiDataset2D", "NiftiDataset3D", "BatchLoader", "list_cases",
    "remap_label", "build_pipeline", "build_transform",
    "build_transform_list", "register_transform", "transform_names",
]
