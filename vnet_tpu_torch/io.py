"""NIfTI I/O and resampling, shared with the JAX package.

``vnet_tpu.io`` imports no JAX (numpy, scipy and the NIfTI reader), so the
port reads, resamples and writes volumes through it unchanged. Callers of
the port (``chip_smoke.py``, the evaluator) reach it through this module.
"""

from vnet_tpu.io import (LINEAR, NEAREST, MedicalImage, pad_to_size,
                         read_image, resample_like, write_image,
                         zeros_like_geometry)

__all__ = [
    "LINEAR", "NEAREST", "MedicalImage", "pad_to_size", "read_image",
    "resample_like", "write_image", "zeros_like_geometry",
]
