"""Contrast calibration of the 2D quality task: the matched-filter oracle
over candidate lesion contrasts.

    python -m vnet_tpu_torch.experiments.diag2d.oracle2d_sweep \
        [--contrasts 0.6 1.0 1.5 2.0 3.0] [--n-cases 4] [--seed 123]

The port's counterpart of ``scripts/experiments/diag2d/oracle2d_sweep.py``:
at the 0.6-sigma contrast of the hard synthetic data the oracle caps far
below a passable Dice, so this runs ``oracle2d_r5``'s oracle on freshly
generated ``make_hard_case`` cases (``--n-cases`` of 96x96x64 from
``default_rng(--seed)``, the same generator at each contrast) and prints
each contrast's pooled best class-1 and class-2 Dice and thresholds
(searched over ``THRESHOLDS``), in the JAX script's lines: the contrast
at which a 2D model can legitimately pass. numpy and scipy only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ...utils.synthdata import make_hard_case
from .oracle2d_r5 import best_threshold, volume_scores

THRESHOLDS = np.arange(2.0, 10.0, 0.25)
CONTRASTS = (0.6, 1.0, 1.5, 2.0, 3.0)


def oracle_dice(contrast: float, n_cases: int = 4, seed: int = 123):
    """``[(class-1 Dice, threshold), (class-2 Dice, threshold)]`` of the
    oracle pooled over ``n_cases`` fresh cases at ``contrast``."""
    rng = np.random.default_rng(seed)
    scores, truths = [], []
    for _ in range(n_cases):
        img, lbl = make_hard_case(rng, contrast=contrast)
        scores.append(volume_scores(np.asarray(img.data)))
        truths.append(np.asarray(lbl.data))
    all_s = np.concatenate([s.ravel() for s in scores])
    all_t = np.concatenate([t.ravel() for t in truths])
    return [best_threshold(all_s, all_t, sign, THRESHOLDS)
            for sign in (+1, -1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contrasts", type=float, nargs="+",
                    default=list(CONTRASTS),
                    help="lesion contrasts in background-noise sigmas")
    ap.add_argument("--n-cases", type=int, default=4)
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args(argv)
    for contrast in args.contrasts:
        (d1, t1), (d2, t2) = oracle_dice(contrast, args.n_cases, args.seed)
        print(f"contrast {contrast:.1f}: oracle pooled dice "
              f"class1 {d1:.3f} @thr {t1}, class2 {d2:.3f} @thr {t2}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
