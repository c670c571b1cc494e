"""2D quality probe: is the model good and the evaluation path broken, or
did training itself fail?

    python -m vnet_tpu_torch.experiments.diag2d.probe2d_r5 \
        [--workdir tmp/quality2d] [--device cuda|cpu]

The port's counterpart of ``scripts/experiments/diag2d/probe2d_r5.py``
(which hard-codes ``tmp/quality2d``). The workdir's network, restored by
its ``Evaluator``, segments slices drawn through the training pipeline
(``NiftiDataset2D.get_sample``), and the per-class Dice of the argmax of
``models.eval_apply`` is printed in three regimes:

* A: the first 32 inventory slices (the inventory is shuffled) at the
  training batch of 32 — what training saw;
* B: the same slices at an evaluation batch of 4 — batch-norm batch-size
  sensitivity;
* C / C1: the inventory slices of the first slice's case at batch 4 — the
  content mix of one case.

The C line gives the case's depth where the JAX script prints a fixed
"of 64 total" (its workdir's cases were 64 deep).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ...io import read_image
from . import dice3, predict, restore, samples, train_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="tmp/quality2d",
                    help="a trained 2D workdir holding config.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg, ev = restore(args.workdir, args.device)
    ds = train_dataset(cfg)

    def dice_of(images, labels, bs):
        return dice3(predict(ev.network, images, bs, ev.device),
                     np.stack(labels))

    # A/B: the first 32 inventory slices (the slice list is pre-shuffled)
    imgs, lbls = samples(ds, range(32))
    print("A  train-pipeline slices, b32:", dice_of(imgs, lbls, 32),
          flush=True)
    print("B  same slices,          b4 :", dice_of(imgs, lbls, 4), flush=True)

    # C: the inventory slices of one training case, in inventory order
    case = ds.slices[0][0]
    idxs = [i for i, (c, _) in enumerate(ds.slices) if c == case]
    depth = read_image(os.path.join(ds.data_dir, case,
                                    ds.label_filename)).GetSize()[2]
    print(f"C  case {case}: {len(idxs)} inventory slices of {depth} total")
    imgs_c, lbls_c = samples(ds, idxs)
    print("C1 one case's inventory slices, b4:", dice_of(imgs_c, lbls_c, 4),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
