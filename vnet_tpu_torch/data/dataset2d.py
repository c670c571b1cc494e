"""2D slice dataset with a labelled-slice inventory.

Equivalent of reference `pipeline/NiftiDataset2D.py:39-299`: a pre-pass
over all cases builds a slice list (a z-slice is kept if its smallest
per-class pixel count exceeds ``min_pixel``, otherwise kept with probability
``drop_ratio``, `NiftiDataset2D.py:93-135`); a sample applies the 3D
transforms to the volume, extracts the slice, then applies the 2D
transforms (`NiftiDataset2D.py:242-279`).

The port's copy of ``vnet_tpu/data/dataset2d.py``, unchanged in behaviour
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

from ..io.nifti import MedicalImage, read_image, zeros_like_geometry
from .dataset3d import check_consistent_headers, list_cases, remap_label
from .rand import get_rng


def slice_min_class_count(label_slice: np.ndarray, classes: Sequence[int]) -> int:
    """Smallest pixel count among the non-background classes; 0 if any class
    is absent (`NiftiDataset2D.py:110-124`)."""
    min_pixel = np.iinfo(np.int64).max
    for value in classes:
        if value == 0:
            continue
        count = int(np.count_nonzero(label_slice == value))
        if count == 0:
            return 0
        min_pixel = min(min_pixel, count)
    return 0 if min_pixel == np.iinfo(np.int64).max else min_pixel


def extract_slice(img: MedicalImage, z: int) -> MedicalImage:
    """sitk ExtractImageFilter along z (`NiftiDataset2D.py:258-270`):
    slice ``z`` with its 2D geometry (spacing/origin/direction)."""
    D = img.direction_matrix()
    # explicit copy (not just ascontiguousarray, which can alias when the
    # slice view happens to be contiguous): callers mutate the result
    # while the source may be a shared cache entry (_cached_volume)
    return MedicalImage(np.array(img.data[:, :, z], order="C"),
                        img.spacing[:2],
                        img.TransformIndexToPhysicalPoint((0, 0, z))[:2],
                        tuple(D[:2, :2].ravel()))


class NiftiDataset2D:
    """Iterable over (case, z) slices yielding ``(image[x,y,C] f32,
    label[x,y] i32)``."""

    def __init__(self, data_dir: str = "", image_filenames=("image.nii",),
                 label_filename: str = "label.nii", transforms3D=None,
                 transforms2D=None, train: bool = False,
                 labels: Sequence[int] = (0, 1), min_pixel: int = 5,
                 drop_ratio: float = 0.1, cache_cases: int = 0):
        self.data_dir = data_dir
        self.image_filenames = list(image_filenames)
        self.label_filename = label_filename
        self.transforms3D = transforms3D or []
        self.transforms2D = transforms2D or []
        self.train = train
        self.labels = list(labels)
        self.min_pixel = min_pixel
        self.drop_ratio = drop_ratio
        # memoize decode + the deterministic 3D-transform prefix per case
        # (same design as NiftiDataset3D.cache_cases: the 2D path re-reads
        # the WHOLE 3D volume for every slice sample, so this is the
        # difference between O(volume) and O(slice) per sample)
        self.cache_cases = int(cache_cases)
        self._prefix_cache = OrderedDict()
        # see NiftiDataset3D: guards LRU bookkeeping against the thread
        # loader backend's concurrent sample fetches
        self._cache_lock = threading.Lock()
        n_det = 0
        for t in self.transforms3D:
            if getattr(t, "stochastic", False):
                break
            n_det += 1
        self._n_det3d = n_det
        self.slices: List[Tuple[str, int]] = self._build_inventory()

    def warm_cache(self):
        """See NiftiDataset3D.warm_cache (parent-side COW warm-up)."""
        if self.cache_cases <= 0:
            return
        for case in list_cases(self.data_dir)[:self.cache_cases]:
            self._cached_volume(case, copy=False)

    def _cached_volume(self, case: str, copy: bool = True):
        """Load + deterministic 3D prefix for ``case``, memoized.

        ``copy=False`` returns the shared cached entry directly: legal
        only when the caller treats it as read-only (the no-stochastic-
        3D-tail fast path below, where only slice-sized copies are ever
        taken from it)."""
        with self._cache_lock:
            cached = self._prefix_cache.get(case)
            if cached is not None:
                self._prefix_cache.move_to_end(case)
        if cached is None:
            # compute outside the lock (expensive; concurrent misses on
            # the same case just redo identical deterministic work)
            cached = self._load_case(case)
            for t in self.transforms3D[:self._n_det3d]:
                cached = t(cached)
            with self._cache_lock:
                self._prefix_cache[case] = cached
                while len(self._prefix_cache) > self.cache_cases:
                    self._prefix_cache.popitem(last=False)
        if not copy:
            return cached
        return {
            "image": [im.like(np.array(im.data, copy=True))
                      for im in cached["image"]],
            "label": cached["label"].like(
                np.array(cached["label"].data, copy=True)),
        }

    def _build_inventory(self) -> List[Tuple[str, int]]:
        rng = get_rng()
        slices = []
        for case in list_cases(self.data_dir):
            label = read_image(
                os.path.join(self.data_dir, case, self.label_filename))
            for z in range(label.GetSize()[2]):
                count = slice_min_class_count(label.data[:, :, z], self.labels)
                if count > self.min_pixel:
                    slices.append((case, z))
                elif rng.random() <= self.drop_ratio:
                    slices.append((case, z))
        rng.shuffle(slices)  # NiftiDataset2D.py:138
        return [(c, int(z)) for c, z in slices]

    def __len__(self):
        return len(self.slices)

    @property
    def data_size(self):
        return len(self.slices)

    def _extract_slice(self, img: MedicalImage, z: int) -> MedicalImage:
        return extract_slice(img, z)

    def _load_case(self, case: str):
        images = []
        for fname in self.image_filenames:
            path = os.path.join(self.data_dir, case, fname)
            images.append(read_image(path).astype(np.float32))
        check_consistent_headers(images, os.path.join(self.data_dir, case))

        if self.train:
            lpath = os.path.join(self.data_dir, case, self.label_filename)
            label = read_image(lpath)
            check_consistent_headers([images[0], label], lpath)
            label = remap_label(label, self.labels)
        else:
            label = zeros_like_geometry(images[0])
        return {"image": images, "label": label}

    def get_sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        case, z = self.slices[index]
        if self.cache_cases > 0:
            rest3d = self.transforms3D[self._n_det3d:]
            # with no stochastic 3D tail the cached volume is read-only:
            # skip the O(volume) defensive copy; extract_slice below
            # copies only the slice (a pipeline with no 3D transforms at
            # all takes this path too)
            sample = self._cached_volume(case, copy=bool(rest3d))
        else:
            sample = self._load_case(case)
            rest3d = self.transforms3D
        for transform in rest3d:
            sample = transform(sample)

        images2d = [self._extract_slice(im, z) for im in sample["image"]]
        label2d = self._extract_slice(sample["label"], z)
        sample = {"image": images2d, "label": label2d}
        for transform in self.transforms2D:
            sample = transform(sample)

        image_np = np.stack(
            [np.asarray(im.data, dtype=np.float32) for im in sample["image"]],
            axis=-1)
        label_np = np.asarray(sample["label"].data, dtype=np.int32)
        return image_np, label_np

    def __iter__(self):
        for i in range(len(self.slices)):
            yield self.get_sample(i)
