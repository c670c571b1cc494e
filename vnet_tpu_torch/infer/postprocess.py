"""Label post-processing: connected components on the predicted mask.

A copy of ``vnet_tpu/infer/postprocess.py`` (scipy only): importing that
module runs ``vnet_tpu/infer/__init__.py``, which imports JAX.

scipy.ndimage re-implementations of the reference's SimpleITK filters:

* ``extract_largest_connected_component`` —
  the reference's ``model.py:142-167``: connected components of the nonzero
  mask, keep the one with the largest physical volume, return binary.
* ``volume_threshold`` — the reference's ``model.py:117-140``: keep every
  component whose physical volume exceeds the threshold (mm^3), return the
  binary union.

Face connectivity (scipy's default structure) matches
sitk.ConnectedComponentImageFilter's default.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..io import MedicalImage


def _voxel_volume(image: MedicalImage) -> float:
    return float(np.prod(image.spacing))


def extract_largest_connected_component(label: MedicalImage) -> MedicalImage:
    mask = label.data > 0
    cc, n = ndimage.label(mask)
    if n == 0:
        return label.like(np.zeros(label.data.shape, np.uint8))
    counts = np.bincount(cc.ravel())
    counts[0] = 0
    largest = int(np.argmax(counts))
    return label.like((cc == largest).astype(np.uint8))


def volume_threshold(label: MedicalImage, volume: float) -> MedicalImage:
    mask = label.data > 0
    cc, n = ndimage.label(mask)
    out = np.zeros(label.data.shape, np.uint8)
    if n == 0:
        return label.like(out)
    vox = _voxel_volume(label)
    counts = np.bincount(cc.ravel())
    for comp in range(1, n + 1):
        if counts[comp] * vox > volume:
            out[cc == comp] = 1
    return label.like(out)
