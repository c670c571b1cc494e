"""TensorBoard image logging — the reference's ImageLog feature.

Parity with reference `model.py:16-24` (``grayscale_to_rainbow``: a
reversed-hue HSV rainbow colormap over [0,1] softmax maps) and
`model.py:315-334, 449-463, 570-585` (inputs, labels, per-class softmax and
predictions; 3D volumes logged slice-wise along the last spatial axis).
Computed in numpy on already-fetched batches — no device work. The
``writer`` is anything with ``add_image(tag, HWC uint8 array, step,
dataformats="HWC")``: the port's ``train/events.py::EventWriter``.

The port's copy of ``vnet_tpu/train/images.py``, equal in behaviour
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np


def grayscale_to_rainbow(image: np.ndarray) -> np.ndarray:
    """(..., 1)-less grayscale [0,1] -> RGB float [0,1] (model.py:16-24):
    H = (1-v) * 2/3 (red=high, blue=low), S = V = 1."""
    h = (1.0 - np.clip(image, 0.0, 1.0)) * (2.0 / 3.0)
    # HSV -> RGB with s=v=1
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = np.zeros_like(h)
    q = 1.0 - f
    t = f
    one = np.ones_like(h)
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [one, q, p, p, t, one])
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [t, one, one, q, p, p])
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [p, p, t, one, one, q])
    return np.stack([r, g, b], axis=-1)


def label_to_uint8(label: np.ndarray, num_classes: int,
                   zero_in_classes: bool = True) -> np.ndarray:
    """Scale class ids to visible grays (model.py:321-323)."""
    denom = max(num_classes - 1, 1) if zero_in_classes else num_classes
    return (label * (255 // denom)).astype(np.uint8)


def volume_to_slices(volume: np.ndarray) -> np.ndarray:
    """(X, Y, Z) -> (Z, X, Y): z into the batch dim, the reference's
    slice-wise logging transpose (model.py:329)."""
    return np.transpose(volume, (2, 0, 1))


def log_batch_images(writer, tag_prefix: str, images: np.ndarray,
                     labels: np.ndarray, softmax: np.ndarray,
                     pred: np.ndarray, class_ids, step: int,
                     max_batches: int = 1) -> None:
    """Write input channels / label / per-class softmax / prediction image
    grids for up to ``max_batches`` samples.

    Args:
      images: (B, *spatial, C); labels/pred: (B, *spatial);
      softmax: (B, *spatial, num_classes).
    """
    if writer is None:
        return
    num_classes = softmax.shape[-1]
    is_3d = images.ndim == 5

    def emit(tag, img2d_stack):
        # img2d_stack: (N, X, Y) grayscale uint8 or (N, X, Y, 3) float
        for n in range(min(img2d_stack.shape[0], 8)):
            arr = img2d_stack[n]
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            writer.add_image(f"{tag}/{n}", arr, step, dataformats="HWC")

    for b in range(min(images.shape[0], max_batches)):
        for c in range(images.shape[-1]):
            vol = images[b, ..., c]
            stack = volume_to_slices(vol) if is_3d else vol[None]
            emit(f"{tag_prefix}/input_{c}_batch{b}",
                 np.clip(stack, 0, 255).astype(np.uint8))

        lbl = label_to_uint8(labels[b], num_classes)
        stack = volume_to_slices(lbl) if is_3d else lbl[None]
        emit(f"{tag_prefix}/label_batch{b}", stack)

        for k in range(num_classes):
            sm = grayscale_to_rainbow(softmax[b, ..., k])
            stack = (np.transpose(sm, (2, 0, 1, 3)) if is_3d else sm[None])
            emit(f"{tag_prefix}/softmax_{class_ids[k]}_batch{b}",
                 (stack * 255).astype(np.uint8))

        prd = label_to_uint8(pred[b], num_classes)
        stack = volume_to_slices(prd) if is_3d else prd[None]
        emit(f"{tag_prefix}/pred_batch{b}", stack)
