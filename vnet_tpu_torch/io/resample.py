"""Host-side geometric resampling onto arbitrary output grids.

Re-implements the semantics of ``sitk.ResampleImageFilter`` with an identity
transform, as used throughout the reference for spacing resampling
(reference `pipeline/NiftiDataset3D.py:380-396`), pad-via-resample
(`NiftiDataset3D.py:438-454`) and the restore-to-original-grid step of
evaluation (reference `model.py:957-977`).

The mapping is: for each output index ``o``, compute the world point
``w = A_out @ o`` and the continuous input index ``c = A_in^{-1} @ w``, then
interpolate the input array at ``c`` (linear or nearest), with a constant
default value outside the input domain.

The port's copy of ``vnet_tpu/io/resample.py``: the scipy path only (the
JAX package's optional native resampler has the same semantics,
``tests/test_native.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from .nifti import MedicalImage

LINEAR = "linear"
NEAREST = "nearest"
_ORDER = {LINEAR: 1, NEAREST: 0}


def resample_to_grid(
    image: MedicalImage,
    out_size,
    out_spacing,
    out_origin,
    out_direction,
    interpolator: str = LINEAR,
    default_value: float = 0.0,
) -> MedicalImage:
    """Resample ``image`` onto the output grid defined by the geometry args."""
    n = image.ndim
    out_size = tuple(int(s) for s in out_size)

    # identity grid: no interpolation needed (common in evaluation restore
    # when no geometric transform ran — e.g. per-slice restore in 2D eval).
    # Exact tuple equality only; near-identical grids still resample.
    if (out_size == image.GetSize()
            and tuple(float(s) for s in out_spacing) == image.spacing
            and tuple(float(o) for o in out_origin) == image.origin
            and tuple(float(d) for d in out_direction) == image.direction):
        src = np.asarray(image.data)
        if _ORDER[interpolator] != 0:
            # match the interpolating path's dtype promotion
            src = src.astype(np.promote_types(src.dtype, np.float32),
                             copy=False)
        return MedicalImage(src.copy(), image.spacing, image.origin,
                            image.direction)

    out = MedicalImage(np.empty(out_size, dtype=np.uint8), tuple(out_spacing),
                       tuple(out_origin), tuple(out_direction))

    A_in = image.index_to_world_matrix()
    A_out = out.index_to_world_matrix()
    # continuous input index = M @ out_index + offset
    T = np.linalg.inv(A_in) @ A_out
    M = T[:n, :n]
    offset = T[:n, n]

    order = _ORDER[interpolator]
    src = np.asarray(image.data)

    compute_dtype = src.dtype if order == 0 else np.promote_types(src.dtype, np.float32)
    resampled = ndimage.affine_transform(
        src.astype(compute_dtype, copy=False),
        matrix=M,
        offset=offset,
        output_shape=out_size,
        order=order,
        mode="constant",
        cval=default_value,
        prefilter=False,  # order<=1 needs no spline prefilter
    )
    if order == 0:
        resampled = resampled.astype(src.dtype, copy=False)
    out.data = resampled
    return out


def resample_to_spacing(
    image: MedicalImage,
    new_spacing,
    interpolator: str = LINEAR,
    default_value: float = 0.0,
) -> MedicalImage:
    """Resample to a target voxel size, keeping origin/direction.

    Output size follows the reference's ``ceil(old_spacing*old_size/new)``
    (reference `pipeline/NiftiDataset3D.py:375-378`).
    """
    old_spacing = image.spacing
    old_size = image.GetSize()
    new_spacing = tuple(float(s) for s in new_spacing)
    new_size = tuple(
        int(np.ceil(old_spacing[i] * old_size[i] / new_spacing[i]))
        for i in range(image.ndim)
    )
    return resample_to_grid(image, new_size, new_spacing, image.origin,
                            image.direction, interpolator, default_value)


def resample_like(
    image: MedicalImage,
    reference: MedicalImage,
    interpolator: str = LINEAR,
    default_value: float = 0.0,
) -> MedicalImage:
    """Resample onto another image's grid (the eval restore step,
    reference `model.py:957-966`)."""
    return resample_to_grid(image, reference.GetSize(), reference.spacing,
                            reference.origin, reference.direction,
                            interpolator, default_value)


def pad_to_size(
    image: MedicalImage,
    output_size,
    interpolator: str = LINEAR,
    default_value: float = 0.0,
) -> MedicalImage:
    """Grow the grid to at least ``output_size`` (per-axis max with current),
    matching reference `pipeline/NiftiDataset3D.py:420-456`: the origin
    and spacing are kept so new voxels appear at the high-index side.
    """
    size_old = image.GetSize()
    target = [max(int(o), s) for o, s in zip(output_size, size_old)]
    if tuple(target) == size_old:
        return image
    return resample_to_grid(image, target, image.spacing, image.origin,
                            image.direction, interpolator, default_value)
