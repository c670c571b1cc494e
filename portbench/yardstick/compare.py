"""The numbers that decide ``correct``, each against its limit.

Training (the first steps the run takes, against the reference's):

* ``loss_gap``: ``|loss - ref| / |ref|`` of the first step;
  ``loss_gap_all``: the largest of every checked step;
* ``grad_gap``: the worst leaf's ``|norm(g) - norm(g_ref)|`` of the first
  gradient, over the larger of the leaf's reference norm and the median
  leaf's; the program's gradient is worked out from Adam's state after one
  step (``exp_avg / (1 - beta1)``); ``grad_median_gap``: the median
  leaf's;
* ``change_gap``, ``change_median_gap``: the same of each leaf's change
  over the checked steps, which holds the optimizer's update, its learning
  rate and the write-back of the weights (an update that is lost reads 1).

Leaves whose reference gradient is under a thousandth of the median leaf's
are rounding alone (a convolution's bias before a batch norm) and are left
out of the leaf numbers. A workload's ``limits`` say which numbers its
check compares.

Evaluation (each sampled volume, against the reference's sums):

* ``prob_gap``: the largest ``|p - p_ref|`` over voxels and classes of the
  blended probabilities ``acc / weight``;
* ``prob_mean_gap``: their mean.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

SILENT_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep: Iterable[str]) -> List[float]:
    """Each kept leaf's gap; a leaf the program lacks reads as unmoved."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keep]


def sound_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= SILENT_LEAF * med]


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses``, ``grad_norms`` (leaf -> norm of
    the first gradient) and ``params`` (leaf -> tensor after the steps);
    ``p0``: the weights both started from."""
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], ref["losses"])]
    keep = sound_leaves(ref["grad_norms"])

    def change(params):
        return {k: float((params[k].double().to(p0[k].device)
                          - p0[k].double()).norm())
                for k in keep if k in params}

    grads = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], keep)
    changes = _leaf_gaps(change(prog["params"]), change(ref["params"]),
                         keep)
    return {"loss_gap": losses[0], "loss_gap_all": max(losses),
            "grad_gap": max(grads),
            "grad_median_gap": statistics.median(grads),
            "change_gap": max(changes),
            "change_median_gap": statistics.median(changes)}


def eval_numbers(acc: torch.Tensor, weight: torch.Tensor,
                 ref: torch.Tensor) -> Dict[str, float]:
    """``acc`` ``(X, Y, Z, classes)`` and ``weight`` ``(X, Y, Z)`` of the
    program; ``ref`` ``(X, Y, Z, 1 + classes)``, channel 0 the weight."""
    worst, total, count = 0.0, 0.0, 0
    for x in range(0, acc.shape[0], 64):
        a = acc[x:x + 64].to(ref.device, torch.float64)
        w = weight[x:x + 64].to(ref.device, torch.float64)
        r = ref[x:x + 64].double()
        p = a / w.clamp_min(1e-12)[..., None]
        pr = r[..., 1:] / r[..., :1].clamp_min(1e-12)
        d = (p - pr).abs()
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        count += d.numel()
    return {"prob_gap": worst, "prob_mean_gap": total / count}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each number beside its limit; a number
    without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    ok = all(c["value"] is not None and c["value"] == c["value"]
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def worst(readings: List[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """Per number, the largest of several readings (e.g. two volumes)."""
    if not readings:
        return None
    return {k: max(r[k] for r in readings) for k in readings[0]}
