"""NIfTI I/O and resampling of the port: its own copy of ``vnet_tpu/io``
(``nifti``, ``resample``), equal in behaviour."""

from .nifti import MedicalImage, read_image, write_image, zeros_like_geometry
from .resample import (LINEAR, NEAREST, pad_to_size, resample_like,
                       resample_to_grid, resample_to_spacing)

__all__ = [
    "MedicalImage", "read_image", "write_image", "zeros_like_geometry",
    "LINEAR", "NEAREST", "pad_to_size", "resample_like", "resample_to_grid",
    "resample_to_spacing",
]
