"""2D quality probe: where between the training slices and a held-out
volume does a 2D model lose its Dice?

    python -m vnet_tpu_torch.experiments.diag2d.probe2d_r5c [WORKDIR] \
        [--workdir tmp/r5_q2d] [--device cuda|cpu]

The port's counterpart of ``scripts/experiments/diag2d/probe2d_r5c.py``,
with the JAX script's lines, on the workdir's ``Evaluator`` network:

* A: 64 training-pipeline inventory slices at batch 32: Dice, and the
  predicted against the true fraction of each foreground class — good
  here and bad on volumes is over-prediction on empty slices, bad here
  the soft/argmax gap;
* A2: the same inventory positions through the evaluation 2D chain (a
  second ``NiftiDataset2D``, which draws its own inventory, as the JAX
  script's does): Dice, fractions, and how many slices hold each class;
* B: every z-slice of the first evaluation case, windowed 40..160 as the
  evaluation chain does (``data/transforms3d.py``'s ``_window``), in one
  stacked call as the evaluator makes it: Dice, fractions, and the mean
  predicted foreground fraction on the slices with no foreground;
* D: the same volume under the running averages (the network built with
  ``norm="batch"`` in float32, as the JAX script builds it, loaded from
  the same weights);
* E: the same volume under batch statistics in chunks of 32 — batch
  composition at fixed content.

The workdir is the positional argument, else ``--workdir``, else
``tmp/r5_q2d``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ...data.transforms3d import _window
from ...io import read_image
from ...models import build_network
from . import dice3, predict, restore, samples, train_dataset


def _fractions(tag, pred, truth):
    for c in (1, 2):
        print(f"{tag} class {c}: pred frac {float((pred == c).mean()):.5f} "
              f"truth frac {float((truth == c).mean()):.5f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=None,
                    help="a trained 2D workdir holding config.json")
    ap.add_argument("--workdir", dest="workdir_opt", default="tmp/r5_q2d",
                    help="the workdir where none is given by position")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg, ev = restore(args.workdir or args.workdir_opt, args.device)

    def predict_(images, bs=32):
        return predict(ev.network, images, bs, ev.device)

    # A: 64 inventory slices through the training pipeline
    ds = train_dataset(cfg)
    imgs, lbls = samples(ds, range(64))
    pred, truth = predict_(imgs), np.stack(lbls)
    print("A train-pipeline slices b32 dice:", dice3(pred, truth), flush=True)
    _fractions("A", pred, truth)

    # A2: the same positions through the evaluation 2D chain (no rotation,
    # flip or translation): a jump in Dice means the training-side
    # augmentation shifts the statistics; no jump, an undertrained class
    ds_raw = train_dataset(cfg, "evaluate")
    imgs2, lbls2 = samples(ds_raw, range(64))
    pred2, truth2 = predict_(imgs2), np.stack(lbls2)
    print("A2 unaugmented inventory slices b32 dice:", dice3(pred2, truth2),
          flush=True)
    _fractions("A2", pred2, truth2)
    n1 = sum(1 for lb in lbls2 if (lb == 1).sum() > 0)
    n2 = sum(1 for lb in lbls2 if (lb == 2).sum() > 0)
    px2 = sorted(int((lb == 2).sum()) for lb in lbls2)
    print(f"A2 inventory: {n1}/64 slices contain class1, {n2}/64 class2; "
          f"class2 px quartiles {px2[16]}/{px2[32]}/{px2[48]}", flush=True)

    # B: every z-slice of one evaluation case, one stacked call
    case_dir = sorted(os.listdir(cfg.evaluate.data_dir))[0]
    img3d, lab3d = (np.asarray(read_image(os.path.join(
        cfg.evaluate.data_dir, case_dir, name)).data)
        for name in ("image.nii", "label.nii"))
    slices = [_window(img3d[:, :, z].astype(np.float32), 40, 160)[..., None]
              for z in range(img3d.shape[2])]
    labels = [lab3d[:, :, z] for z in range(img3d.shape[2])]
    pred, truth = predict_(slices, bs=len(slices)), np.stack(labels)
    print(f"B eval case {case_dir}: volume dice", dice3(pred, truth),
          flush=True)
    _fractions("B", pred, truth)
    empty = [float((p > 0).mean()) for p, lb in zip(pred, labels)
             if (lb > 0).sum() == 0]
    fp_on_empty = np.mean(empty) if empty else 0.0
    print(f"B empty slices: {len(empty)}/{len(labels)}, mean predicted-fg "
          f"fraction on them {fp_on_empty:.5f}", flush=True)

    # D: the same volume under the running averages (EMA statistics)
    n = cfg.train.network
    ema_net = build_network(
        n.name, num_classes=len(cfg.train.segmentation_classes),
        num_channels=n.num_channel, num_levels=n.num_levels,
        num_convolutions=n.num_convolutions,
        bottom_convolutions=n.bottom_convolutions, dropout_rate=n.dropout,
        norm="batch", packed_target_lanes=n.packed_target_lanes,
        device=ev.device, spatial_rank=2)
    ema_net.load_state_dict(ev.network.state_dict())
    pred_ema = predict(ema_net, slices, 32, ev.device)
    print(f"D eval case {case_dir} EMA-stats dice:", dice3(pred_ema, truth),
          flush=True)
    _fractions("D", pred_ema, truth)

    # E: batch statistics over chunks of 32 of the same volume
    print(f"E eval case {case_dir} batch-stats b32 dice:",
          dice3(predict_(slices, bs=32), truth), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
