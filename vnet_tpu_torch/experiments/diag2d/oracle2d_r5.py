"""2D achievability oracle for the hard synthetic data.

    python -m vnet_tpu_torch.experiments.diag2d.oracle2d_r5 \
        [--workdir tmp/quality2d]

The port's counterpart of ``scripts/experiments/diag2d/oracle2d_r5.py``
(which hard-codes ``tmp/quality2d``): a per-slice matched-filter detector
with every advantage a 2D model could hope for — the generative model
known (disk-like lesions shifted by +/- contrast sigmas, a smooth
multiplicative bias), multi-scale matched filters, and per-class
thresholds tuned on the evaluation cases themselves. Over every case
under ``<workdir>/evaluate`` (``image.nii``, ``label.nii``), each z-slice
is scored by :func:`slice_scores`; the class-1 and class-2 thresholds
that maximise the pooled Dice are searched over ``THRESHOLDS``, then each
case's per-class Dice under them is printed, in the JAX script's lines.
A trained 2D network far below this bound has a recipe problem; an
oracle near zero means the task cannot be passed slice by slice. numpy
and scipy only: no device.

Where no threshold gives a class a Dice above 0, the JAX script fails on
a ``None`` threshold (``TypeError``); this one stops with a message that
names the class.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from scipy import ndimage

from ...io import read_image
from ...utils.synthdata import dice_per_class

THRESHOLDS = np.arange(2.0, 8.0, 0.25)
SIGMAS = (1.0, 1.5, 2.0, 3.0)


def slice_scores(sl: np.ndarray) -> np.ndarray:
    """Multi-scale matched-filter score map of one slice (positive: class-1
    evidence, negative: class-2 evidence)."""
    # the bias field is smooth (a 4x4x4 coarse grid over 96x96x64, an
    # in-plane wavelength of ~32 px): divide it out by a heavy blur
    bias = ndimage.gaussian_filter(sl, 16.0)
    flat = sl / np.maximum(bias, 1e-6)
    flat = (flat - np.median(flat)) / (flat.std() + 1e-9)
    # matched filters at the lesion radii (2..5): a normalised gaussian
    # mean is about a disk average; smoothing cuts the noise's std by
    # ~1 / (2 sqrt(pi) sigma) in 2D, so scale back to noise units
    best = np.zeros_like(flat)
    for sigma in SIGMAS:
        snr = ndimage.gaussian_filter(flat, sigma) * (
            2.0 * np.sqrt(np.pi) * sigma)
        best = np.where(np.abs(snr) > np.abs(best), snr, best)
    return best


def volume_scores(vol: np.ndarray) -> np.ndarray:
    """:func:`slice_scores` of every z-slice of an ``(x, y, z)`` volume."""
    return np.stack([slice_scores(vol[:, :, z]) for z in range(vol.shape[2])],
                    axis=2)


def best_threshold(all_s: np.ndarray, all_t: np.ndarray, sign: int,
                   thresholds=THRESHOLDS):
    """``(Dice, threshold)`` of the threshold whose ``sign * score >
    threshold`` best matches class 1 (``sign`` +1) or class 2 (-1) of the
    pooled voxels; ``(0.0, None)`` where none scores above 0."""
    cls = 1 if sign > 0 else 2
    t = all_t == cls
    best = (0.0, None)
    for thr in thresholds:
        pred = (sign * all_s) > thr
        d = 2.0 * (pred & t).sum() / max(pred.sum() + t.sum(), 1)
        if d > best[0]:
            best = (float(d), float(thr))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="tmp/quality2d",
                    help="a 2D quickstart-style workdir; its evaluate/ "
                         "cases are scored")
    args = ap.parse_args(argv)

    root = os.path.join(args.workdir, "evaluate")
    cases = sorted(os.listdir(root))
    scores, truths = [], []
    for case in cases:
        img = np.asarray(read_image(os.path.join(root, case,
                                                 "image.nii")).data)
        truths.append(np.asarray(read_image(os.path.join(root, case,
                                                         "label.nii")).data))
        scores.append(volume_scores(img))
    all_s = np.concatenate([s.ravel() for s in scores])
    all_t = np.concatenate([t.ravel() for t in truths])

    d1, t1 = best_threshold(all_s, all_t, +1)
    d2, t2 = best_threshold(all_s, all_t, -1)
    for cls, thr in ((1, t1), (2, t2)):
        if thr is None:
            raise SystemExit(f"oracle: no threshold in {THRESHOLDS[0]}.."
                             f"{THRESHOLDS[-1]} gives class {cls} a Dice "
                             f"above 0 on {root}")
    print(f"oracle pooled dice: class1 {d1:.3f} @thr {t1}, "
          f"class2 {d2:.3f} @thr {t2}", flush=True)
    for case, s, t in zip(cases, scores, truths):
        pred = np.zeros(t.shape, np.uint8)
        pred[s > t1] = 1
        pred[-s > t2] = 2
        d = dice_per_class(pred, t, 3)
        print(f"{case}: oracle dice {[round(float(x), 3) for x in d]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
