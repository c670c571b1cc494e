"""3D case dataset: NIfTI loading, header checks, label remapping,
transform chains — the equivalent of
reference `pipeline/NiftiDataset3D.py:10-165` without the tf.data /
py_func machinery: a plain iterable of numpy samples that the prefetching
loader (``loader.py``) parallelizes and batches. The port's copy of
``vnet_tpu/data/dataset3d.py`` without the attention networks' distance-map
target (attention networks are not ported yet).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.nifti import MedicalImage, read_image, zeros_like_geometry

IGNORED_ENTRIES = (".DS_Store", "@eaDir")  # NiftiDataset3D.py:40-45


def list_cases(data_dir: str) -> List[str]:
    cases = [c for c in sorted(os.listdir(data_dir))
             if c not in IGNORED_ENTRIES
             and os.path.isdir(os.path.join(data_dir, c))]
    return cases


def check_consistent_headers(images: Sequence[MedicalImage], path: str = ""):
    """Size/spacing/direction consistency across channels
    (`NiftiDataset3D.py:79-92`)."""
    ref = images[0]
    for img in images[1:]:
        same_size = img.GetSize() == ref.GetSize()
        same_spacing = np.allclose(img.spacing, ref.spacing, atol=1e-4)
        same_direction = np.allclose(img.direction, ref.direction, atol=1e-4)
        if not (same_size and same_spacing and same_direction):
            raise ValueError(
                f"Header info inconsistent: {path}\nSame size: {same_size}\n"
                f"Same spacing: {same_spacing}\nSame direction: {same_direction}")


def remap_label(label: MedicalImage, classes: Sequence[int]) -> MedicalImage:
    """Map raw label values to consecutive class indices: value
    ``classes[i]`` -> ``i`` (`NiftiDataset3D.py:119-137`); values not in
    ``classes`` become 0."""
    data = label.data
    out = np.zeros(data.shape, dtype=np.uint8)
    for i, value in enumerate(classes):
        out[data == value] = i
    return label.like(out)


class NiftiDataset3D:
    """Iterable over cases yielding ``(image[x,y,z,C] f32, label[x,y,z] i32)``.

    Mirrors the reference constructor signature
    (`NiftiDataset3D.py:22-37`); ``train=False`` creates an empty label of
    matching geometry (`NiftiDataset3D.py:94-97`).
    """

    def __init__(self, data_dir: str = "", image_filenames=("image.nii",),
                 label_filename: str = "label.nii", transforms=None,
                 train: bool = False, labels: Sequence[int] = (0, 1),
                 cache_cases: int = 0):
        self.data_dir = data_dir
        self.image_filenames = list(image_filenames)
        self.label_filename = label_filename
        self.transforms = transforms or []
        self.train = train
        self.labels = list(labels)
        self.cases = list_cases(data_dir)
        # cache_cases > 0: memoize decode + the DETERMINISTIC transform
        # prefix (everything before the first transform marked
        # ``stochastic = True``) per case, LRU-bounded. The reference
        # re-reads and re-resamples the whole volume for every crop
        # (`NiftiDataset3D.py:62-165`); with ~0.3-0.4 s/case of
        # decode+resample vs ~0.1 s of stochastic tail (measured,
        # scripts/benchmark_loader.py) this is a 3-4x loader speedup with
        # bitwise-identical samples. Per-process cache: with the process
        # loader backend each worker holds its own copy.
        self.cache_cases = int(cache_cases)
        self._prefix_cache = OrderedDict()
        # guards the LRU bookkeeping (insert/evict/move_to_end) against the
        # thread loader backend's concurrent get_sample calls; the fork
        # backend never contends (each worker owns a COW copy)
        self._cache_lock = threading.Lock()
        n_det = 0
        for t in self.transforms:
            if getattr(t, "stochastic", False):
                break
            n_det += 1
        self._n_deterministic = n_det

    def __len__(self):
        return len(self.cases)

    @property
    def data_size(self):
        return len(self.cases)

    def warm_cache(self):
        """Fill the deterministic-prefix cache up front (parent process).
        With the fork-based process loader backend, workers are re-forked
        each epoch and would rebuild their caches from scratch; warming in
        the parent lets every fork inherit the cache via copy-on-write."""
        if self.cache_cases <= 0 or self._n_deterministic == 0:
            return
        # the stochastic crops' per-case CC memo (transforms3d) is
        # module-level: warming it here lets every per-epoch fork inherit
        # the bboxes/centroids instead of re-labeling each case per epoch
        tail_names = {type(t).__name__
                      for t in self.transforms[self._n_deterministic:]}
        warm_cc = tail_names & {"ConfidenceCrop", "ConfidenceCrop2"}
        if warm_cc:
            from .transforms3d import _cc_bboxes, _cc_centroids
        for case in self.cases[:self.cache_cases]:
            if case in self._prefix_cache:
                continue
            sample = self.load_case(case)
            for t in self.transforms[:self._n_deterministic]:
                sample = t(sample)
            self._prefix_cache[case] = sample
            if "ConfidenceCrop2" in warm_cc:
                _cc_bboxes(sample["label"].data >= 1)
            if "ConfidenceCrop" in warm_cc:
                _cc_centroids(sample["label"].data >= 1)

    def load_case(self, case: str):
        """Read + header-check + remap, no transforms. Returns the sample
        dict ``{'image': [MedicalImage], 'label': MedicalImage}``."""
        images = []
        for fname in self.image_filenames:
            path = os.path.join(self.data_dir, case, fname)
            try:
                images.append(read_image(path))
            except FileNotFoundError:
                raise
            except Exception as e:
                raise IOError(f"Error loading image: {path}: {e}") from e
        check_consistent_headers(images, os.path.join(self.data_dir, case))

        if self.train:
            lpath = os.path.join(self.data_dir, case, self.label_filename)
            try:
                label = read_image(lpath)
            except Exception as e:
                raise IOError(f"Error loading label: {lpath}: {e}") from e
            check_consistent_headers([images[0], label], lpath)
            label = remap_label(label, self.labels)
        else:
            label = zeros_like_geometry(images[0])
        return {"image": images, "label": label}

    def get_sample(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Parse one case through the transform chain
        (`NiftiDataset3D.py:62-165`)."""
        case = self.cases[index]

        def apply(sample, transforms):
            for transform in transforms:
                try:
                    sample = transform(sample)
                except Exception as e:
                    raise RuntimeError(
                        f"Dataset preprocessing error: {case} transform: "
                        f"{getattr(transform, 'name', transform)}: {e}"
                    ) from e
            return sample

        if self.cache_cases > 0 and self._n_deterministic > 0:
            with self._cache_lock:
                cached = self._prefix_cache.get(case)
                if cached is not None:
                    self._prefix_cache.move_to_end(case)
            if cached is None:
                # compute outside the lock (expensive; concurrent misses on
                # the same case just redo identical deterministic work)
                cached = apply(self.load_case(case),
                               self.transforms[:self._n_deterministic])
                with self._cache_lock:
                    self._prefix_cache[case] = cached
                    while len(self._prefix_cache) > self.cache_cases:
                        self._prefix_cache.popitem(last=False)
            # hand downstream transforms their own copies: some mutate
            # pixel data in place
            sample = {
                "image": [im.like(np.array(im.data, copy=True))
                          for im in cached["image"]],
                "label": cached["label"].like(
                    np.array(cached["label"].data, copy=True)),
            }
            sample = apply(sample, self.transforms[self._n_deterministic:])
        else:
            sample = apply(self.load_case(case), self.transforms)

        image_np = np.stack(
            [np.asarray(im.data, dtype=np.float32) for im in sample["image"]],
            axis=-1)
        label_np = np.asarray(sample["label"].data, dtype=np.int32)
        return image_np, label_np

    def __iter__(self):
        for i in range(len(self.cases)):
            yield self.get_sample(i)
