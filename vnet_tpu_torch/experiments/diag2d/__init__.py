"""The 2D quality probes, counterparts of ``scripts/experiments/diag2d/``:
where does a 2D model trained on the hard synthetic lose its Dice?

* ``oracle2d_r5`` — a per-slice matched-filter oracle on a workdir's
  evaluation cases, thresholds tuned on those cases (an upper bound for
  any per-slice segmenter);
* ``oracle2d_sweep`` — the same oracle over lesion contrasts, on fresh
  ``make_hard_case`` cases;
* ``probe2d_r5`` — a trained 2D workdir's network on train-pipeline
  slices at batch 32 and 4, and on one case's slices;
* ``probe2d_r5b`` — the same slices under ``eval_apply`` and under a
  train-mode forward, argmax Dice and loss of each;
* ``probe2d_r5c`` — predicted against true class fractions, unaugmented
  slices, a whole evaluation volume in one stacked call, under the
  running averages, and in chunks of 32.

The oracles are numpy and scipy only. The probes restore the workdir's
``Evaluator`` (its ``config.json``, its newest ``ckpt_<step>.pt``) on
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
only when asked) and draw slices from the training pipeline's
``NiftiDataset2D``, whose inventory and transforms take the host
generator ``data/rand.py`` (unseeded, as the JAX scripts leave it).
This module holds what the probes share.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ...config import load_config, load_pipeline
from ...data import build_pipeline
from ...data.dataset2d import NiftiDataset2D
from ...device import resolve_device
from ...infer.evaluator import Evaluator
from ...models import eval_apply
from ...utils.synthdata import dice_per_class


def restore(workdir: str, device="cuda"):
    """``(config, Evaluator)`` of the workdir's ``config.json``, the
    network restored from its checkpoint; no card for ``cuda`` raises
    first."""
    resolve_device(device)
    cfg = load_config(os.path.join(workdir, "config.json"))
    return cfg, Evaluator(cfg, device=device)


def train_dataset(cfg, phase: str = "train") -> NiftiDataset2D:
    """The training cases' slice inventory under ``phase``'s 2D chain
    (labels kept: ``train=True`` whatever the chain)."""
    tfms = build_pipeline(load_pipeline(cfg.train.pipeline_path), phase, 2)
    t = cfg.train
    return NiftiDataset2D(
        t.data_dir, t.image_filenames, t.label_filename,
        transforms3D=tfms["3D"], transforms2D=tfms["2D"], train=True,
        labels=t.segmentation_classes, min_pixel=t.min_pixel,
        drop_ratio=t.drop_ratio, cache_cases=8)


def samples(ds: NiftiDataset2D, indices):
    """``(images, labels)``: lists of the inventory's samples, in order."""
    images, labels = [], []
    for i in indices:
        im, lb = ds.get_sample(i)
        images.append(im)
        labels.append(lb)
    return images, labels


def predict(network, images, bs: int, device) -> np.ndarray:
    """Argmax labels of ``images`` through ``eval_apply``, ``bs`` slices a
    call."""
    preds = []
    for i in range(0, len(images), bs):
        x = torch.from_numpy(np.stack(images[i:i + bs])).to(device)
        preds.append(eval_apply(network, x).float().argmax(-1).cpu().numpy())
    return np.concatenate(preds)


def dice3(pred, truth) -> list:
    """Per-class Dice of three classes, rounded to 3 places as printed."""
    return [round(float(d), 3) for d in dice_per_class(pred, truth, 3)]
