"""Per-patch evaluation diagnostic: break a case's sliding-window grid
into its patches and report the hard per-class Dice and the prediction
histogram of each, then of the blended result.

    python -m vnet_tpu_torch.experiments.patch_diagnose --workdir WORKDIR \
        --case evaluate/case_0 [--device cuda|cpu]

The port's counterpart of ``scripts/experiments/patch_diagnose.py``: the
workdir's ``Evaluator`` (its ``config.json``, its newest
``ckpt_<step>.pt``) on one case: the evaluation transforms
(``load_pipeline``, ``build_pipeline``) applied to the image and its
``label.nii``, every patch of ``build_patch_grid`` at the config's patch
and stride as one batch through ``models.eval_apply``, the softmax in
float32, and per patch its start, ``dice_per_class`` against the label's
window and the histogram of its argmax; then the uniform blend of all
patches' probabilities against the whole label. A patch that collapses
inside a batch whose others score well points at the model (batch
statistics shared by the batch), not at the blend. ``--device`` (``cuda``
by default, which raises without a card) replaces the JAX script's
``--devices cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..config import load_config, load_pipeline
from ..data import build_pipeline
from ..infer.evaluator import Evaluator
from ..infer.sliding_window import build_patch_grid
from ..io import read_image
from ..models import eval_apply
from ..utils.synthdata import dice_per_class


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True,
                    help="a quickstart-style workdir holding config.json")
    ap.add_argument("--case", required=True,
                    help="case dir relative to the workdir, e.g. "
                         "evaluate/case_0 (must contain label.nii)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    cfg = load_config(os.path.join(workdir, "config.json"))
    ev = Evaluator(cfg, device=args.device)
    num_classes = ev.t.num_classes

    case_dir = os.path.join(workdir, args.case)
    sample = {"image": [read_image(os.path.join(case_dir, f))
                        for f in ev.e.image_filenames],
              "label": read_image(os.path.join(case_dir, "label.nii"))}
    for tfm in build_pipeline(load_pipeline(ev.e.pipeline_path), "evaluate",
                              ev.t.dimension):
        sample = tfm(sample)
    vol = np.asarray(sample["image"][0].data, np.float32)
    truth = np.asarray(sample["label"].data)

    patch = tuple(ev.t.patch_shape)
    stride = tuple(ev.e.stride)
    grid = build_patch_grid(vol.shape, patch, stride)
    print(f"volume {vol.shape}, {len(grid)} patches "
          f"(patch {patch}, stride {stride})", flush=True)

    slices = [tuple(slice(int(s), int(s) + p) for s, p in zip(row, patch))
              for row in grid]
    batch = np.stack([vol[sl] for sl in slices])[..., None]
    logits = eval_apply(ev.network, torch.from_numpy(batch).to(ev.device))
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()

    acc = np.zeros(vol.shape + (num_classes,), np.float32)
    for i, sl in enumerate(slices):
        ppred = probs[i].argmax(-1)
        plab = truth[sl]
        d = [round(float(x), 3)
             for x in dice_per_class(ppred, plab, num_classes)]
        hist = np.bincount(ppred.ravel(), minlength=num_classes)
        print(f"patch {i:3d} start {tuple(int(s) for s in grid[i])} "
              f"dice {d} predhist {[int(h) for h in hist]}", flush=True)
        acc[sl] += probs[i]

    blended = acc.argmax(-1)
    d = [round(float(x), 3)
         for x in dice_per_class(blended, truth, num_classes)]
    print(f"blended (uniform) dice {d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
