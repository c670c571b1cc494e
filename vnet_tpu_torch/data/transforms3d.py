"""3D preprocessing/augmentation transforms on ``MedicalImage`` samples.

Pure numpy/scipy re-implementations of the reference's SimpleITK transform
classes (reference `pipeline/NiftiDataset3D.py:167-837`), same names,
same constructor signatures (the YAML pipeline schema is unchanged), same
sampling distributions. A sample is ``{'image': [MedicalImage, ...],
'label': MedicalImage}``.

These run on the host (file-touching, geometry-changing work). The
port's copy of ``vnet_tpu/data/transforms3d.py``; the on-device
augmentation of the JAX package is not ported yet.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

import numpy as np
from scipy import ndimage

from ..io.nifti import MedicalImage
from ..io.resample import (LINEAR, NEAREST, pad_to_size, resample_to_spacing)
from .rand import get_rng
from .registry import register_transform


def _window(data: np.ndarray, lo: float, hi: float,
            out_min: float = 0.0, out_max: float = 255.0) -> np.ndarray:
    """sitk.IntensityWindowingImageFilter semantics: linear map of
    [lo, hi] -> [out_min, out_max] with clamping."""
    scale = (out_max - out_min) / max(hi - lo, 1e-12)
    out = (data.astype(np.float64) - lo) * scale + out_min
    return np.clip(out, out_min, out_max).astype(np.float32)


def _crop(img: MedicalImage, start, size) -> MedicalImage:
    """sitk.RegionOfInterestImageFilter: crop + shift origin."""
    slices = tuple(slice(s, s + z) for s, z in zip(start, size))
    new_origin = img.TransformIndexToPhysicalPoint(tuple(start))
    return MedicalImage(np.ascontiguousarray(img.data[slices]), img.spacing,
                        new_origin, img.direction)


def _label_stats_sum(label: MedicalImage) -> float:
    """Binary (>=1) voxel count like the RandomCrop check
    (`NiftiDataset3D.py:506-511,539`)."""
    return float(np.count_nonzero(label.data >= 1))


@register_transform(3)
class Normalization:
    """Rescale intensities to 0-255 (`NiftiDataset3D.py:167-185`)."""

    def __init__(self):
        self.name = "Normalization"

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        for c in range(len(image)):
            d = image[c].data.astype(np.float64)
            lo, hi = float(d.min()), float(d.max())
            image[c] = image[c].like(_window(d, lo, hi))
        return {"image": image, "label": label}


@register_transform(3)
class RandomFlip:
    """Flip all listed axes together with p=0.5
    (`NiftiDataset3D.py:187-208`). ``axes`` is a length-3 bool list."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    def __init__(self, axes):
        self.name = "Flip"
        assert 0 < len(axes) <= 3
        self.axes = axes

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        if get_rng().integers(2):
            flip_dims = tuple(i for i, f in enumerate(self.axes) if f)
            for c in range(len(image)):
                image[c] = image[c].like(
                    np.flip(image[c].data, axis=flip_dims).copy())
            label = label.like(np.flip(label.data, axis=flip_dims).copy())
        return {"image": image, "label": label}


@register_transform(3)
class StatisticalNormalization:
    """Window mean +/- sigma*std -> 0-255, window clamped to the array
    dtype's representable range (`NiftiDataset3D.py:210-254`)."""

    def __init__(self, sigma, pre_norm=False):
        self.name = "StatisticalNormalization"
        assert isinstance(sigma, float)
        self.sigma = sigma
        self.pre_norm = pre_norm

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        for c in range(len(image)):
            d = image[c].data
            if self.pre_norm:
                d = (d.astype(np.float64) - d.mean()) / max(d.std(), 1e-12)
            mean, std = float(d.mean()), float(d.std())
            hi = mean + self.sigma * std
            lo = mean - self.sigma * std
            if np.issubdtype(d.dtype, np.integer):
                info = np.iinfo(d.dtype)
            else:
                info = np.finfo(d.dtype)
            hi = min(hi, float(info.max))
            lo = max(lo, float(info.min))
            image[c] = image[c].like(_window(d, lo, hi))
        return {"image": image, "label": label}


@register_transform(3)
class ExtremumNormalization:
    """Window between percent-trimmed min/max -> 0-255
    (`NiftiDataset3D.py:256-283`)."""

    def __init__(self, percent=0.05):
        self.name = "ExtremumNormalization"
        assert isinstance(percent, float)
        self.percent = percent

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        for c in range(len(image)):
            d = image[c].data
            mn, mx = float(d.min()), float(d.max())
            lo = (mx - mn) * self.percent + mn
            hi = (mx - mn) * (1 - self.percent) + mn
            image[c] = image[c].like(_window(d, lo, hi))
        return {"image": image, "label": label}


@register_transform(3)
class ManualNormalization:
    """Fixed window [windowMin, windowMax] -> 0-255
    (`NiftiDataset3D.py:285-308`)."""

    def __init__(self, windowMin, windowMax):
        self.name = "ManualNormalization"
        self.windowMax = float(windowMax)
        self.windowMin = float(windowMin)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        for c in range(len(image)):
            image[c] = image[c].like(
                _window(image[c].data, self.windowMin, self.windowMax))
        return {"image": image, "label": label}


@register_transform(3)
class Reorient:
    """Permute axes (`NiftiDataset3D.py:310-328`). Applied to every image
    channel (the reference's single-image call is a latent multichannel
    bug we do not reproduce)."""

    def __init__(self, order):
        self.name = "Reorient"
        assert len(order) == 3
        self.order = tuple(int(o) for o in order)

    def _permute(self, img: MedicalImage) -> MedicalImage:
        o = self.order
        D = img.direction_matrix()[:, list(o)]
        return MedicalImage(
            np.ascontiguousarray(np.transpose(img.data, o)),
            tuple(img.spacing[i] for i in o), img.origin,
            tuple(D.ravel()))

    def __call__(self, sample):
        image = [self._permute(im) for im in sample["image"]]
        label = self._permute(sample["label"])
        return {"image": image, "label": label}


@register_transform(3)
class Invert:
    """Invert intensity about 255 (`NiftiDataset3D.py:330-343`)."""

    def __init__(self):
        self.name = "Invert"

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        image = [im.like((255.0 - im.data.astype(np.float32))) for im in image]
        return {"image": image, "label": label}


@register_transform(3)
class Resample:
    """Resample to a target voxel size: linear for images, nearest for the
    label (`NiftiDataset3D.py:345-398`)."""

    def __init__(self, voxel_size):
        self.name = "Resample"
        if isinstance(voxel_size, (int, float)):
            self.voxel_size = (float(voxel_size),) * 3
        else:
            assert len(voxel_size) == 3
            self.voxel_size = tuple(float(v) for v in voxel_size)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        image = [resample_to_spacing(im, self.voxel_size, LINEAR)
                 for im in image]
        label = resample_to_spacing(label, self.voxel_size, NEAREST)
        return {"image": image, "label": label}


@register_transform(3)
class Padding:
    """Grow to at least output_size (`NiftiDataset3D.py:400-456`)."""

    def __init__(self, output_size):
        self.name = "Padding"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 3
        else:
            assert len(output_size) == 3
            self.output_size = tuple(int(s) for s in output_size)
        assert all(i > 0 for i in self.output_size)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        image = [pad_to_size(im, self.output_size, LINEAR) for im in image]
        label = pad_to_size(label, self.output_size, NEAREST)
        return {"image": image, "label": label}


@register_transform(3)
class RandomCrop:
    """Rejection-sampled random crop: retry until the crop contains at
    least ``min_pixel`` labelled voxels, accepting empty crops with
    probability ``drop_ratio`` (`NiftiDataset3D.py:458-551`)."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    def __init__(self, output_size, drop_ratio=0.1, min_pixel=1):
        self.name = "Random Crop"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 3
        else:
            assert len(output_size) == 3
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
        ldata = label.data
        # Candidate checks count labelled voxels directly on the crop view
        # (~0.2 ms for 64^3) — building a whole-volume integral image costs
        # ~150 ms (measured, 192x192x96), i.e. only pays off past ~500
        # rejections. The integral is built lazily if the loop ever runs
        # that hot (near-empty labels with min_pixel > 0 and tiny
        # drop_ratio); the acceptance predicate is identical either way.
        integral = None

        def crop_sum(s):
            e = [s[i] + min(size_new[i], size_old[i]) for i in range(3)]
            if integral is None:
                view = ldata[s[0]:e[0], s[1]:e[1], s[2]:e[2]]
                return np.count_nonzero(view >= 1)
            return (
                integral[e[0], e[1], e[2]]
                - integral[s[0], e[1], e[2]] - integral[e[0], s[1], e[2]]
                - integral[e[0], e[1], s[2]]
                + integral[s[0], s[1], e[2]] + integral[s[0], e[1], s[2]]
                + integral[e[0], s[1], s[2]]
                - integral[s[0], s[1], s[2]]
            )

        attempts = 0
        while True:
            start = [0 if size_old[i] <= size_new[i]
                     else int(rng.integers(0, size_old[i] - size_new[i]))
                     for i in range(3)]
            if crop_sum(start) >= self.min_pixel:
                break
            if rng.random() <= self.drop_ratio:
                break
            attempts += 1
            if attempts == 64 and integral is None:
                integral = np.pad((ldata >= 1).astype(np.int64),
                                  [(1, 0)] * 3).cumsum(0).cumsum(1).cumsum(2)

        size = [min(size_new[i], size_old[i]) for i in range(3)]
        image = [_crop(im, start, size) for im in image]
        label = _crop(label, start, size)
        return {"image": image, "label": label}


@register_transform(3)
class RandomNoise:
    """Additive Gaussian noise, mean 0 (`NiftiDataset3D.py:553-572`)."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    def __init__(self, sigma=5):
        self.name = "Random Noise"
        self.sigma = sigma

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        rng = get_rng()
        out = []
        for im in image:
            noise = rng.normal(0.0, self.sigma, size=im.data.shape)
            out.append(im.like((im.data.astype(np.float32) + noise.astype(np.float32))))
        return {"image": out, "label": label}


def _connected_components(binary: np.ndarray):
    """scipy.ndimage.label with sitk-compatible full (3,3,3) connectivity?

    sitk's ConnectedComponentImageFilter uses face connectivity by default;
    scipy's default structure is also face connectivity — matched.
    """
    return ndimage.label(binary)


def _label_digest(binary: np.ndarray):
    """Cheap content key for per-case CC memoization (~2.5 ms at 192^3 vs
    ~50 ms for ndimage.label). The label reaching the stochastic crops is
    byte-identical across every sample drawn from the same case (it is the
    deterministic-prefix output), so digest hits are exact repeats; crc32
    is backed by nnz + shape to make accidental collisions irrelevant in
    practice (a collision would only skew augmentation sampling)."""
    buf = np.ascontiguousarray(binary)
    return (binary.shape, int(np.count_nonzero(binary)),
            zlib.crc32(buf.view(np.uint8).tobytes()))


_CC_MEMO_MAX = 128  # entries are tiny (ints + bbox/centroid tuples)
_cc_objs_memo: "OrderedDict" = OrderedDict()
_cc_centroids_memo: "OrderedDict" = OrderedDict()
_cc_memo_lock = threading.Lock()


def _memoized(memo, key, compute):
    with _cc_memo_lock:
        if key in memo:
            memo.move_to_end(key)
            return memo[key]
    value = compute()
    with _cc_memo_lock:
        memo[key] = value
        while len(memo) > _CC_MEMO_MAX:
            memo.popitem(last=False)
    return value


def _cc_bboxes(binary: np.ndarray):
    """(ncc, find_objects slices) of the label's components, memoized."""
    def compute():
        cc, ncc = _connected_components(binary)
        return ncc, tuple(ndimage.find_objects(cc)) if ncc else ()
    return _memoized(_cc_objs_memo, _label_digest(binary), compute)


def _cc_centroids(binary: np.ndarray):
    """(ncc, per-component centroids) of the label, memoized."""
    def compute():
        cc, ncc = _connected_components(binary)
        if ncc == 0:
            return 0, ()
        cents = ndimage.center_of_mass(binary, cc, range(1, ncc + 1))
        return ncc, tuple(tuple(c) for c in cents)
    return _memoized(_cc_centroids_memo, _label_digest(binary), compute)


@register_transform(3)
class ConfidenceCrop:
    """Crop around a randomly chosen connected-component centroid with a
    Gaussian offset (`NiftiDataset3D.py:574-659`)."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    def __init__(self, output_size, sigma=2.5):
        self.name = "Confidence Crop"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 3
        else:
            assert len(output_size) == 3
            self.output_size = tuple(int(s) for s in output_size)
        if isinstance(sigma, float) and sigma >= 0:
            self.sigma = (sigma,) * 3
        else:
            assert len(sigma) == 3
            self.sigma = tuple(sigma)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        size = label.GetSize()
        out = self.output_size
        rng = get_rng()

        ncc, centroids = _cc_centroids(label.data >= 1)
        if ncc == 0:
            centroid = [out[i] // 2 for i in range(3)]
        else:
            chosen = int(rng.integers(1, ncc + 1))
            centroid = [int(round(c)) for c in centroids[chosen - 1]]

        start = [0, 0, 0]
        for i in range(3):
            c = centroid[i]
            # edge clamping (NiftiDataset3D.py:637-641)
            if c < out[i] / 2:
                c = out[i] // 2
            elif size[i] - c < out[i] / 2:
                c = size[i] - out[i] // 2 - 1
            s, e = -1, size[i]  # force loop entry
            while s < 0 or e > size[i] - 1:
                offset = int(round(rng.normal(0, out[i] * self.sigma[i] / 2)))
                s = c + offset - out[i] // 2
                e = s + out[i] - 1
            start[i] = s

        image = [_crop(im, start, out) for im in image]
        label = _crop(label, start, out)
        return {"image": image, "label": label}


@register_transform(3)
class ConfidenceCrop2:
    """Positive/negative patch sampling around connected-component bounding
    boxes (`NiftiDataset3D.py:661-793`): with probability ``probability``
    crop near a random CC bbox center jittered by ``rand_range``; otherwise
    crop a random (optionally label-free) region."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    def __init__(self, output_size, rand_range=3, probability=0.5,
                 random_empty_region=False):
        self.name = "Confidence Crop 2"
        if isinstance(output_size, int):
            self.output_size = (output_size,) * 3
        else:
            assert len(output_size) == 3
            self.output_size = tuple(int(s) for s in output_size)
        if isinstance(rand_range, int):
            self.rand_range = (rand_range,) * 3
        else:
            assert len(rand_range) == 3
            self.rand_range = tuple(rand_range)
        assert 0 <= probability <= 1
        self.probability = probability
        self.random_empty_region = random_empty_region

    def _clamp_start(self, idx, size):
        out = self.output_size
        for i in range(3):
            if size[i] - idx[i] - 1 < out[i]:
                idx[i] = size[i] - out[i] - 1
            if idx[i] < 0:
                idx[i] = 0
        return idx

    def _random_region(self, image, label):
        rng = get_rng()
        size = label.GetSize()
        idx = [0 if size[i] - self.output_size[i] <= 0
               else int(rng.integers(0, max(size[i] - self.output_size[i] - 1, 1)))
               for i in range(3)]
        size_c = [min(self.output_size[i], size[i]) for i in range(3)]
        return ([_crop(im, idx, size_c) for im in image],
                _crop(label, idx, size_c))

    def _random_empty_region(self, image, label):
        rng = get_rng()
        size = label.GetSize()
        for _ in range(200):
            idx = [0 if size[i] - self.output_size[i] <= 0
                   else int(rng.integers(0, max(size[i] - self.output_size[i] - 1, 1)))
                   for i in range(3)]
            size_c = [min(self.output_size[i], size[i]) for i in range(3)]
            lab = _crop(label, idx, size_c)
            if _label_stats_sum(lab) < 1:
                return [_crop(im, idx, size_c) for im in image], lab
        return self._random_region(image, label)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        rng = get_rng()

        positive = rng.random() < self.probability
        if not positive:
            if self.random_empty_region:
                image, label = self._random_empty_region(image, label)
            else:
                image, label = self._random_region(image, label)
            return {"image": image, "label": label}

        ncc, bboxes = _cc_bboxes(label.data >= 1)
        if ncc == 0:
            if self.random_empty_region:
                image, label = self._random_empty_region(image, label)
            else:
                image, label = self._random_region(image, label)
            return {"image": image, "label": label}

        chosen = int(rng.integers(1, ncc + 1))
        objs = bboxes[chosen - 1]
        size = image[0].GetSize()
        idx = [0, 0, 0]
        for i in range(3):
            bbox_start = objs[i].start
            bbox_len = objs[i].stop - objs[i].start
            jitter = int(rng.integers(-self.rand_range[i], self.rand_range[i] + 1))
            idx[i] = bbox_start + bbox_len // 2 - self.output_size[i] // 2 + jitter
        idx = self._clamp_start(idx, size)
        size_c = [min(self.output_size[i], size[i]) for i in range(3)]
        image = [_crop(im, idx, size_c) for im in image]
        label = _crop(label, idx, size_c)
        return {"image": image, "label": label}


@register_transform(3)
class BSplineDeformation:
    """Free-form deformation from a random coarse control grid
    (`NiftiDataset3D.py:795-832`): random control-point displacements of
    magnitude ``randomness`` (in physical mm, matching the reference's
    BSplineTransform parameters) on a 10^3 mesh, upsampled with cubic
    interpolation to a dense displacement field, applied to image (linear)
    and label (nearest)."""

    stochastic = True  # uses RNG: not cacheable as a deterministic prefix

    MESH = (10, 10, 10)
    SPLINE_ORDER = 3

    def __init__(self, randomness=10):
        self.name = "BSpline Deformation"
        if randomness <= 0:
            raise RuntimeError("Randomness should be non zero values")
        self.randomness = randomness

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        shape = image[0].GetSize()
        rng = get_rng()

        # Control grid covers the volume; displacements in voxel units
        # (converted from physical by dividing by spacing per axis).
        coords = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        warped_coords = []
        ctrl_shape = tuple(m + self.SPLINE_ORDER for m in self.MESH)
        for axis in range(3):
            ctrl = rng.random(ctrl_shape) * self.randomness
            disp_phys = ndimage.zoom(
                ctrl, [shape[i] / ctrl_shape[i] for i in range(3)],
                order=self.SPLINE_ORDER, mode="nearest", grid_mode=True)
            disp_vox = disp_phys / image[0].spacing[axis]
            warped_coords.append(coords[axis] + disp_vox)

        def warp(data, order):
            return ndimage.map_coordinates(
                data.astype(np.float32 if order else data.dtype), warped_coords,
                order=order, mode="constant", cval=0.0, prefilter=False)

        image = [im.like(warp(im.data, 1)) for im in image]
        label = label.like(warp(label.data, 0))
        return {"image": image, "label": label}
