"""Offline accuracy harness: checkpoint x stride grid search with Dice /
Jaccard and lesion-wise detection metrics — the port's counterpart of
``vnet_tpu/utils/batch_evaluate.py``, scoring with the same functions and
evaluating each grid point with the port's ``Evaluator`` on the device the
caller names (``cuda`` unless asked for ``cpu``).

    python -m vnet_tpu_torch.utils.batch_evaluate --config_json CONFIG \
        --stride_inplane 64 96 --stride_layer 32 --modes DICE ITEM \
        --csv out/grid.csv [--device cpu]

In-process re-design of the reference's `utils/batch_evaluate/`
(batch_evaluate.py + main.py): the reference shells out
``python evaluate.py ...`` per grid combo (batch_evaluate.py:234-245);
here each combo reconfigures the evaluator and runs in-process.

Metrics parity:
* ``overlap_measures`` — Dice/Jaccard of the binarized masks, like
  ``sitk.LabelOverlapMeasuresImageFilter`` (batch_evaluate.py:15-28).
* ``lesion_detection`` — connected components of ground truth vs output;
  TP when an output CC centroid lies within ``tolerance`` (physical mm) of
  a ground-truth centroid (batch_evaluate.py:30-118), with the reference's
  output-CC extent filter (bbox z-thickness >= 6, x/y extent >= 2).
* ``lesion_volume_buckets`` — the stride sweep's small/large lesion volume
  accounting (batch_evaluate_stride.py:55-86): CCs below the volume of an
  r=1 mm sphere are ignored, the rest are split at the volume of an
  r=2.5 mm sphere; per-bucket summed physical volumes are reported for
  ground truth and (extent-filtered) output.
"""

from __future__ import annotations

import argparse
import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ..config import Config
from ..data.dataset3d import list_cases
from ..io import MedicalImage, read_image


def overlap_measures(ground_truth: MedicalImage, output: MedicalImage) -> Dict[str, float]:
    gt = ground_truth.data > 0
    pr = output.data > 0
    inter = float(np.logical_and(gt, pr).sum())
    a, b = float(gt.sum()), float(pr.sum())
    union = a + b - inter
    dice = 2.0 * inter / (a + b) if (a + b) else 1.0
    jaccard = inter / union if union else 1.0
    return {"DICE": dice, "Jaccard": jaccard}


def _passes_extent_filter(slices, thickness_threshold: int) -> bool:
    """Output-CC bbox extent filter (batch_evaluate.py:69-77): reject CCs
    thinner than ``thickness_threshold`` in z or < 2 voxels in x/y."""
    ext = [s.stop - s.start for s in slices]
    return not (ext[2] < thickness_threshold or ext[0] < 2 or ext[1] < 2)


def _component_centroids(image: MedicalImage, extent_filter: bool = False,
                         thickness_threshold: int = 6) -> List[Tuple[float, ...]]:
    """Physical-space centroids of connected components; optional bbox
    extent filter as applied to outputs (batch_evaluate.py:69-77)."""
    cc, n = ndimage.label(image.data > 0)
    centroids = []
    objects = ndimage.find_objects(cc)
    for i in range(n):
        if extent_filter and not _passes_extent_filter(objects[i],
                                                       thickness_threshold):
            continue
        com = ndimage.center_of_mass(cc == (i + 1))
        centroids.append(image.TransformIndexToPhysicalPoint(
            tuple(float(c) for c in com)))
    return centroids


def lesion_detection(ground_truth: MedicalImage, output: MedicalImage,
                     tolerance: float = 3.0,
                     thickness_threshold: int = 6) -> Dict[str, float]:
    gt_centroids = _component_centroids(ground_truth)
    out_centroids = _component_centroids(output, extent_filter=True,
                                         thickness_threshold=thickness_threshold)

    if not gt_centroids:  # batch_evaluate.py:86-88
        return {"TP": 0, "FP": len(out_centroids), "FN": 0,
                "sensitivity": 0.0, "IoU": 0.0}

    tp = fn = 0
    for g in gt_centroids:
        found = any(np.linalg.norm(np.subtract(g, o)) < tolerance
                    for o in out_centroids)
        tp += int(found)
        fn += int(not found)
    fp = len(out_centroids) - tp
    sens = tp / (tp + fn) if (tp + fn) else 0.0
    iou = tp / (tp + fp + fn) if (tp + fp + fn) else 0.0
    return {"TP": tp, "FP": fp, "FN": fn, "sensitivity": sens, "IoU": iou}


# Volume thresholds of the stride sweep (batch_evaluate_stride.py:60-64):
# CCs smaller than an r=1 mm sphere are ignored; the small/large split is
# at the volume of an r=2.5 mm sphere.
_MIN_LESION_VOLUME = 4.0 / 3.0 * np.pi
_SMALL_LESION_VOLUME = 4.0 / 3.0 * np.pi * 2.5 ** 3


def _bucket_volumes(image: MedicalImage, extent_filter: bool = False,
                    thickness_threshold: int = 6) -> Tuple[float, float]:
    cc, n = ndimage.label(image.data > 0)
    voxel_vol = float(np.prod(image.spacing))
    counts = np.bincount(cc.ravel(), minlength=n + 1)
    objects = ndimage.find_objects(cc)
    small = large = 0.0
    for i in range(n):
        if extent_filter and not _passes_extent_filter(objects[i],
                                                       thickness_threshold):
            continue  # batch_evaluate_stride.py:76-80
        size = counts[i + 1] * voxel_vol
        if size < _MIN_LESION_VOLUME:
            continue
        if size < _SMALL_LESION_VOLUME:
            small += size
        else:
            large += size
    return small, large


def lesion_volume_buckets(ground_truth: MedicalImage, output: MedicalImage,
                          thickness_threshold: int = 6) -> Dict[str, float]:
    """Small/large lesion volume accounting of the reference stride sweep
    (batch_evaluate_stride.py:55-86): gt buckets are unfiltered; output CCs
    first pass the bbox extent filter, like its centroid accounting."""
    gt_small, gt_large = _bucket_volumes(ground_truth)
    out_small, out_large = _bucket_volumes(
        output, extent_filter=True, thickness_threshold=thickness_threshold)
    return {"gt_vol_small": gt_small, "gt_vol_large": gt_large,
            "label_vol_small": out_small, "label_vol_large": out_large}


@dataclass
class GridResult:
    checkpoint: str
    stride_inplane: int
    stride_layer: int
    per_case: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def mean(self, key: str) -> float:
        vals = [c[key] for c in self.per_case.values() if key in c]
        return float(np.mean(vals)) if vals else float("nan")


class BatchEvaluate:
    """The grid search (the reference's `utils/batch_evaluate/main.py`)."""

    def __init__(self, config: Config, ground_truth_filename: str = "label.nii",
                 checkpoints: Optional[Sequence[str]] = None,
                 stride_inplane_range: Sequence[int] = (64,),
                 stride_layer_range: Sequence[int] = (32,),
                 tolerance: float = 3.0, modes: Sequence[str] = ("DICE",),
                 device="cuda"):
        self.config = config
        self.device = device
        self.ground_truth_filename = ground_truth_filename
        self.checkpoints = list(checkpoints or [config.evaluate.checkpoint_path
                                                or config.train.ckpt_dir])
        self.stride_inplane_range = list(stride_inplane_range)
        self.stride_layer_range = list(stride_layer_range)
        self.tolerance = tolerance
        self.modes = list(modes)

    def score_case(self, case_dir: str, label_filename: str) -> Optional[Dict[str, float]]:
        gt_path = os.path.join(case_dir, self.ground_truth_filename)
        out_path = os.path.join(case_dir, label_filename)
        if not (os.path.exists(gt_path) and os.path.exists(out_path)):
            return None
        gt = read_image(gt_path)
        out = read_image(out_path)
        result: Dict[str, float] = {}
        if "DICE" in self.modes:
            result.update(overlap_measures(gt, out))
        if "ITEM" in self.modes:
            result.update(lesion_detection(gt, out, self.tolerance))
        if "VOLUME" in self.modes:
            result.update(lesion_volume_buckets(gt, out))
        return result

    def run(self, csv_path: Optional[str] = None) -> List[GridResult]:
        from ..infer import Evaluator

        results = []
        e = self.config.evaluate
        for ckpt in self.checkpoints:
            for si in self.stride_inplane_range:
                for sl in self.stride_layer_range:
                    e.checkpoint_path = ckpt
                    if self.config.train.dimension == 3:
                        e.stride = (si, si, sl)
                    else:
                        e.stride = (si, si)
                    Evaluator(self.config, device=self.device).evaluate()

                    grid = GridResult(ckpt, si, sl)
                    for case in list_cases(e.data_dir):
                        score = self.score_case(
                            os.path.join(e.data_dir, case), e.label_filename)
                        if score is not None:
                            grid.per_case[case] = score
                    results.append(grid)

        if csv_path:
            self.write_csv(results, csv_path)
        return results

    def write_csv(self, results: List[GridResult], path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        keys = sorted({k for r in results for c in r.per_case.values()
                       for k in c})
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["checkpoint", "stride_inplane", "stride_layer",
                        "case"] + keys)
            for r in results:
                for case, score in sorted(r.per_case.items()):
                    w.writerow([r.checkpoint, r.stride_inplane,
                                r.stride_layer, case]
                               + [score.get(k, "") for k in keys])
                w.writerow([r.checkpoint, r.stride_inplane, r.stride_layer,
                            "MEAN"] + [r.mean(k) for k in keys])

    @staticmethod
    def best(results: List[GridResult], key: str = "DICE") -> GridResult:
        return max(results, key=lambda r: r.mean(key))


def main(argv=None):
    """The grid search's command line, with ``scripts/batch_evaluate.py``'s
    flags and ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.utils.batch_evaluate")
    p.add_argument("--config_json", required=True)
    p.add_argument("--ground_truth", default="label.nii")
    p.add_argument("--checkpoints", nargs="*", default=None)
    p.add_argument("--stride_inplane", nargs="*", type=int, default=[64])
    p.add_argument("--stride_layer", nargs="*", type=int, default=[32])
    p.add_argument("--tolerance", type=float, default=3.0)
    p.add_argument("--modes", nargs="*", default=["DICE"],
                   choices=["DICE", "ITEM"])
    p.add_argument("--csv", default="batch_evaluate.csv")
    p.add_argument("--device", default="cuda",
                   help="torch device of the evaluations (cuda or cpu)")
    args = p.parse_args(argv)

    from ..config import load_config

    config = load_config(args.config_json)
    be = BatchEvaluate(config, ground_truth_filename=args.ground_truth,
                       checkpoints=args.checkpoints,
                       stride_inplane_range=args.stride_inplane,
                       stride_layer_range=args.stride_layer,
                       tolerance=args.tolerance, modes=args.modes,
                       device=args.device)
    results = be.run(csv_path=args.csv)
    best = BatchEvaluate.best(results, "DICE" if "DICE" in args.modes
                              else "sensitivity")
    print(f"best: ckpt={best.checkpoint} stride_inplane="
          f"{best.stride_inplane} stride_layer={best.stride_layer} "
          f"mean={best.mean('DICE'):.4f}")
    return results


if __name__ == "__main__":
    main()
