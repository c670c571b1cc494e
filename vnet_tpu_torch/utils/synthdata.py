"""Hard synthetic segmentation benchmark generator — the port's copy of
``vnet_tpu/utils/synthdata.py`` (numpy only). From the same
``np.random.default_rng(seed)`` it draws the same arrays and writes the
same NIfTI bytes as the JAX package's generator
(``tests/test_torch_utils.py``), so a run on the card trains on the cases
a TPU run trained on.

The round-1 quality proof was a trivially-separable bright sphere
(+120 on sigma-5 background). This generator produces the hard case the
BASELINE quality north star needs when no LiTS data is available:

* 3 classes (background + 2 foreground) of IRREGULAR blobs — unions of
  spheres stamped along random walks, not single spheres;
* <= ``fg_fraction`` total foreground (default 1%), class 2 rarer than
  class 1 (exercises the weighted-loss path and its sum-form caveat,
  ops/losses.py);
* heavy intensity OVERLAP: class means shifted by ``contrast`` standard
  deviations of the background noise (0.6 sigma default — per-voxel Bayes
  error ~38%, so the net must use spatial context, unlike the round-1
  sphere);
* a smooth multiplicative bias field (0.9-1.1) so global thresholds and
  naive normalization don't trivialize the task.

Used by the port's quickstart (``python -m vnet_tpu_torch.quickstart``)
and ``experiments/attn_quality.py``.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..io.nifti import MedicalImage, write_image


def _stamp_walk(label: np.ndarray, rng, cls: int, n_steps: int,
                radius_range: Tuple[int, int], max_voxels: int) -> int:
    """Stamp spheres along a random walk; returns voxels added (stops at
    ``max_voxels``)."""
    shape = label.shape
    pos = np.array([rng.integers(r + 2, s - r - 2)
                    for s, r in zip(shape, [radius_range[1]] * 3)])
    added = 0
    for _ in range(n_steps):
        r = int(rng.integers(radius_range[0], radius_range[1] + 1))
        lo = np.maximum(pos - r, 0)
        hi = np.minimum(pos + r + 1, shape)
        zz, yy, xx = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        sphere = ((zz - pos[0]) ** 2 + (yy - pos[1]) ** 2
                  + (xx - pos[2]) ** 2) <= r * r
        region = label[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        new = sphere & (region == 0)
        if added + int(new.sum()) > max_voxels:
            break
        region[new] = cls
        added += int(new.sum())
        # drift: biased small step keeps the blob connected but irregular
        pos = pos + rng.integers(-r, r + 1, size=3)
        pos = np.clip(pos, radius_range[1] + 1,
                      np.array(shape) - radius_range[1] - 2)
    return added


def _bias_field(shape, rng, strength: float = 0.1) -> np.ndarray:
    """Smooth multiplicative gain in [1-strength, 1+strength]: a coarse
    random grid upsampled by separable linear interpolation."""
    coarse = rng.normal(size=(4, 4, 4))
    field = coarse
    for axis, target in enumerate(shape):
        idx = np.linspace(0, field.shape[axis] - 1, target)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, field.shape[axis] - 1)
        w = (idx - lo).reshape([-1 if a == axis else 1 for a in range(3)])
        field = (np.take(field, lo, axis=axis) * (1 - w)
                 + np.take(field, hi, axis=axis) * w)
    field = (field - field.mean()) / (np.abs(field).max() + 1e-9)
    return (1.0 + strength * field).astype(np.float32)


def make_hard_case(rng, shape=(96, 96, 64), spacing=(0.75, 0.75, 0.75),
                   fg_fraction: float = 0.01, contrast: float = 0.6,
                   noise_sigma: float = 20.0, bg_mean: float = 100.0,
                   bias_strength: float = 0.1):
    """One case: (image MedicalImage f32, label MedicalImage uint8)."""
    n_vox = int(np.prod(shape))
    label = np.zeros(shape, np.uint8)
    budget1 = int(n_vox * fg_fraction * 0.75)   # class 1: ~0.75% TOTAL
    budget2 = int(n_vox * fg_fraction * 0.25)   # class 2: rarer
    for _ in range(int(rng.integers(2, 4))):
        budget1 -= _stamp_walk(label, rng, 1,
                               n_steps=int(rng.integers(4, 9)),
                               radius_range=(2, 5), max_voxels=budget1)
    for _ in range(int(rng.integers(1, 3))):
        budget2 -= _stamp_walk(label, rng, 2,
                               n_steps=int(rng.integers(3, 6)),
                               radius_range=(2, 4), max_voxels=budget2)

    img = rng.normal(bg_mean, noise_sigma, size=shape).astype(np.float32)
    img[label == 1] += contrast * noise_sigma
    img[label == 2] -= contrast * noise_sigma
    img *= _bias_field(shape, rng, bias_strength)
    return (MedicalImage(img, spacing),
            MedicalImage(label, spacing))


def make_hard_case_multimodal(rng, shape=(96, 96, 64),
                              spacing=(0.75, 0.75, 0.75),
                              fg_fraction: float = 0.01,
                              contrast: float = 0.6,
                              noise_sigma: float = 20.0,
                              bg_mean: float = 100.0,
                              bias_strength: float = 0.1):
    """Two-modality hard case: each foreground class is separable in ONE
    channel only (class 1 bright in channel 1, class 2 dark in channel 2;
    invisible in the other) — a net reaching per-class Dice on BOTH
    classes must fuse the modalities (exercises the reference's
    multi-channel input stack, `NiftiDataset3D.py:60-88` /
    `model.py:351-361`, end-to-end). Independent noise and bias fields
    per channel. Returns ``([ch1, ch2], label)``."""
    n_vox = int(np.prod(shape))
    label = np.zeros(shape, np.uint8)
    budget1 = int(n_vox * fg_fraction * 0.75)
    budget2 = int(n_vox * fg_fraction * 0.25)
    for _ in range(int(rng.integers(2, 4))):
        budget1 -= _stamp_walk(label, rng, 1,
                               n_steps=int(rng.integers(4, 9)),
                               radius_range=(2, 5), max_voxels=budget1)
    for _ in range(int(rng.integers(1, 3))):
        budget2 -= _stamp_walk(label, rng, 2,
                               n_steps=int(rng.integers(3, 6)),
                               radius_range=(2, 4), max_voxels=budget2)

    ch1 = rng.normal(bg_mean, noise_sigma, size=shape).astype(np.float32)
    ch1[label == 1] += contrast * noise_sigma      # class 2 invisible here
    ch1 *= _bias_field(shape, rng, bias_strength)
    ch2 = rng.normal(bg_mean, noise_sigma, size=shape).astype(np.float32)
    ch2[label == 2] -= contrast * noise_sigma      # class 1 invisible here
    ch2 *= _bias_field(shape, rng, bias_strength)
    return ([MedicalImage(ch1, spacing), MedicalImage(ch2, spacing)],
            MedicalImage(label, spacing))


def make_hard_dataset(root: str, split: str, num_cases: int, rng=None,
                      shape=(96, 96, 64), write_labels: bool = True,
                      multimodal: bool = False, **case_kw) -> str:
    """``multimodal=True`` writes ``image.nii`` + ``image_t2.nii`` per
    case (make_hard_case_multimodal; filenames match
    configs/config_attention_multimodal.json)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    split_dir = os.path.join(root, split)
    os.makedirs(split_dir, exist_ok=True)
    for i in range(num_cases):
        case_dir = os.path.join(split_dir, f"case_{i}")
        os.makedirs(case_dir, exist_ok=True)
        if multimodal:
            chans, lbl = make_hard_case_multimodal(rng, shape=shape,
                                                   **case_kw)
            write_image(chans[0], os.path.join(case_dir, "image.nii"))
            write_image(chans[1], os.path.join(case_dir, "image_t2.nii"))
        else:
            img, lbl = make_hard_case(rng, shape=shape, **case_kw)
            write_image(img, os.path.join(case_dir, "image.nii"))
        if write_labels:
            write_image(lbl, os.path.join(case_dir, "label.nii"))
    return split_dir


def dice_per_class(pred: np.ndarray, truth: np.ndarray,
                   num_classes: int) -> list:
    out = []
    for c in range(num_classes):
        p = pred == c
        t = truth == c
        denom = p.sum() + t.sum()
        out.append(1.0 if denom == 0 else 2.0 * (p & t).sum() / denom)
    return out
