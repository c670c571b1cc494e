"""Compare two prediction volumes per case (e.g. the ``xla`` blend's
against the ``pallas`` blend's).

    python -m vnet_tpu_torch.experiments.compare_preds ROOT \
        pred_xla.nii.gz pred_pallas.nii.gz [tol]

The port's counterpart of ``scripts/experiments/compare_preds.py``: for
every case directory under ROOT that holds both files, the share of voxels
whose labels differ; exit code 1 when no case holds both or when any case
disagrees on more than ``tol`` of its voxels (default 1e-4, 0.01%: the
labels are integers, and the two blends add the same numbers in the same
order, so they should agree but at float ties). For a model whose
probabilities sit near a class boundary over large regions, calibrate
``tol`` against the disagreement of one blend between two devices first.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import read_image


def main(argv) -> int:
    root, name_a, name_b = argv[1], argv[2], argv[3]
    tol = float(argv[4]) if len(argv) > 4 else 1e-4

    worst = 0.0
    compared = 0
    for case in sorted(os.listdir(root)):
        pa = os.path.join(root, case, name_a)
        pb = os.path.join(root, case, name_b)
        if not (os.path.isfile(pa) and os.path.isfile(pb)):
            continue
        a = np.asarray(read_image(pa).data)
        b = np.asarray(read_image(pb).data)
        frac = float((a != b).mean())
        worst = max(worst, frac)
        compared += 1
        print(f"{case}: disagree {frac:.6%} of voxels", flush=True)
    if not compared:
        print(f"no cases with both {name_a} and {name_b} under {root}",
              flush=True)
        return 1
    print(f"worst case disagreement: {worst:.6%} (tol {tol:.6%})",
          flush=True)
    return 0 if worst <= tol else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
