"""2D slice transforms: numpy/scipy re-implementations of the reference's
2D transform classes (reference `pipeline/NiftiDataset2D.py:297-633`), same
names and constructor signatures for YAML compatibility.

The port's copy of ``vnet_tpu/data/transforms2d.py``, unchanged in
behaviour (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..io.resample import LINEAR, NEAREST, pad_to_size, resample_to_spacing
from .rand import get_rng
from .registry import register_transform
from .transforms3d import _crop, _window


@register_transform(2)
class ManualNormalization:
    """Fixed window -> 0-255 (`NiftiDataset2D.py:297-320`)."""

    def __init__(self, windowMin, windowMax):
        self.name = "Manual Normalization"
        self.windowMax = float(windowMax)
        self.windowMin = float(windowMin)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        for c in range(len(image)):
            image[c] = image[c].like(
                _window(image[c].data, self.windowMin, self.windowMax))
        return {"image": image, "label": label}


@register_transform(2)
class Resample:
    """Resample to 2D voxel size (`NiftiDataset2D.py:322-380`)."""

    def __init__(self, voxel_size):
        self.name = "Resample"
        if isinstance(voxel_size, (int, float)):
            self.voxel_size = (float(voxel_size),) * 2
        else:
            assert len(voxel_size) == 2
            self.voxel_size = tuple(float(v) for v in voxel_size)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        image = [resample_to_spacing(im, self.voxel_size, LINEAR)
                 for im in image]
        label = resample_to_spacing(label, self.voxel_size, NEAREST)
        return {"image": image, "label": label}


@register_transform(2)
class Padding:
    """Grow to at least output_size (`NiftiDataset2D.py:381-438`)."""

    def __init__(self, output_size):
        self.name = "Padding"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 2
        else:
            assert len(output_size) == 2
            self.output_size = tuple(int(s) for s in output_size)
        assert all(i > 0 for i in self.output_size)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        image = [pad_to_size(im, self.output_size, LINEAR) for im in image]
        label = pad_to_size(label, self.output_size, NEAREST)
        return {"image": image, "label": label}


@register_transform(2)
class RandomCrop:
    """Rejection-sampled crop; if the whole slice holds fewer than
    ``min_pixel`` labelled pixels any crop is accepted immediately
    (`NiftiDataset2D.py:440-532`, whole-slice check :493-497)."""

    def __init__(self, output_size, drop_ratio=0.1, min_pixel=1):
        self.name = "Random Crop"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 2
        else:
            assert len(output_size) == 2
            self.output_size = tuple(int(s) for s in output_size)
        if not 0 <= drop_ratio <= 1:
            raise RuntimeError("Drop ratio should be between 0 and 1")
        self.drop_ratio = drop_ratio
        if not (isinstance(min_pixel, int) and min_pixel >= 0):
            raise RuntimeError("Min label pixel count should be integer larger than 0")
        self.min_pixel = min_pixel

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        size_old = image[0].GetSize()
        size_new = self.output_size
        rng = get_rng()
        binary = label.data >= 1

        done = bool(binary.sum() < self.min_pixel)
        start = [0, 0]
        while True:
            start = [0 if size_old[i] <= size_new[i]
                     else int(rng.integers(0, size_old[i] - size_new[i]))
                     for i in range(2)]
            if done:
                break
            s = binary[start[0]:start[0] + size_new[0],
                       start[1]:start[1] + size_new[1]].sum()
            if s >= self.min_pixel or rng.random() <= self.drop_ratio:
                break

        size = [min(size_new[i], size_old[i]) for i in range(2)]
        image = [_crop(im, start, size) for im in image]
        label = _crop(label, start, size)
        return {"image": image, "label": label}


@register_transform(2)
class RandomFlip:
    """Independent LR/UD flips, each with p=0.5
    (`NiftiDataset2D.py:534-569`)."""

    def __init__(self):
        self.name = "Random Flip"

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        rng = get_rng()
        axes = []
        if rng.integers(2):
            axes.append(0)
        if rng.integers(2):
            axes.append(1)
        if axes:
            image = [im.like(np.flip(im.data, axis=tuple(axes)).copy())
                     for im in image]
            label = label.like(np.flip(label.data, axis=tuple(axes)).copy())
        return {"image": image, "label": label}


@register_transform(2)
class RandomRotate:
    """Rotation about the slice centre by a uniform angle in [-90, 90)
    degrees; linear for images, nearest for the label
    (`NiftiDataset2D.py:571-598`)."""

    def __init__(self):
        self.name = "Random Rotate"

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        angle = float(get_rng().integers(-90, 90))
        image = [im.like(ndimage.rotate(im.data.astype(np.float32), angle,
                                        reshape=False, order=1,
                                        mode="constant", cval=0.0))
                 for im in image]
        label = label.like(ndimage.rotate(label.data, angle, reshape=False,
                                          order=0, mode="constant", cval=0))
        return {"image": image, "label": label}


@register_transform(2)
class RandomTranslate:
    """Random integer translation within maxOffset
    (`NiftiDataset2D.py:600-624`)."""

    def __init__(self, maxOffset=(25, 25)):
        self.name = "Random Translate"
        self.maxOffset = tuple(maxOffset)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        rng = get_rng()
        # sitk's TranslationTransform moves the sampling grid, which shifts
        # image content by -offset; the visual effect is a shift either way.
        shift = [int(rng.integers(-self.maxOffset[i], self.maxOffset[i]))
                 for i in range(2)]
        image = [im.like(ndimage.shift(im.data.astype(np.float32), shift,
                                       order=1, mode="constant", cval=0.0))
                 for im in image]
        label = label.like(ndimage.shift(label.data, shift, order=0,
                                         mode="constant", cval=0))
        return {"image": image, "label": label}


@register_transform(2)
class RadialDistortion:
    """Stub matching the reference's incomplete class
    (`NiftiDataset2D.py:626-633`): identity."""

    def __init__(self):
        self.name = "Radial Distortion"

    def __call__(self, sample):
        return sample
