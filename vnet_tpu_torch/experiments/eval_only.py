"""Re-run only the evaluation half of a quickstart workdir from its saved
checkpoint, with the blend implementation forced on the command line.

    python -m vnet_tpu_torch.experiments.eval_only --workdir WORKDIR \
        [--blend-impl xla|pallas|auto] [--suffix S] [--data-dir DIR] \
        [--max-cases N] [--device cuda|cpu]

The port's counterpart of ``scripts/experiments/eval_only.py``: it loads
``WORKDIR/config.json``, sets ``BlendImpl`` to ``--blend-impl``, restores
the newest ``ckpt_<step>.pt`` under the config's ``CheckpointPath`` (as
the port's ``Evaluator`` does), evaluates the cases of
``EvaluateDataDirectory`` (or of ``--data-dir``, the first ``--max-cases``
of them) and prints one line of per-class Dice a case against its
``label.nii``. Running one checkpoint through both blends on the same
card separates model quality from the evaluation path's numerics;
``--data-dir`` pointed at the training cases separates overfitting from
faults of the evaluation path (training Dice high and held-out Dice low is
overfitting). ``--suffix S`` writes ``<label>_S.nii.gz`` beside each case
instead of overwriting the label file, so that ``compare_preds`` can hold
two runs against each other. ``--device`` (``cuda`` by default, which
raises without a card) replaces the JAX script's ``--devices cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import load_config
from ..infer.evaluator import Evaluator
from ..io import read_image
from ..utils.synthdata import dice_per_class


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--blend-impl", default="xla",
                    choices=["xla", "pallas", "auto"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--suffix", default=None,
                    help="write preds as pred_<suffix>.nii.gz instead of "
                         "overwriting pred.nii.gz")
    ap.add_argument("--data-dir", default=None,
                    help="evaluate a different case directory (e.g. the "
                         "training dir, to split overfitting from eval-path "
                         "faults: train Dice high + held-out low = overfit)")
    ap.add_argument("--max-cases", type=int, default=None,
                    help="evaluate only the first N cases of --data-dir")
    args = ap.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    cfg = load_config(os.path.join(workdir, "config.json"))
    cfg.evaluate.blend_impl = args.blend_impl
    if args.suffix:
        base, ext = cfg.evaluate.label_filename.split(".nii")
        cfg.evaluate.label_filename = f"{base}_{args.suffix}.nii{ext}"
    if args.data_dir:
        cfg.evaluate.data_dir = os.path.abspath(args.data_dir)

    ev = Evaluator(cfg, device=args.device)
    results = ev.evaluate(max_cases=args.max_cases)
    print(f"blend_impl={args.blend_impl}: evaluated {len(results)} case(s)",
          flush=True)
    num_classes = ev.t.num_classes
    for pred_path in results:
        case_dir = os.path.dirname(pred_path)
        truth = np.asarray(
            read_image(os.path.join(case_dir, "label.nii")).data)
        pred = np.asarray(read_image(pred_path).data)
        d = dice_per_class(pred, truth, num_classes)
        print(f"{os.path.basename(case_dir)} [{args.blend_impl}]: dice "
              f"per class {[round(float(x), 3) for x in d]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
