"""Per-batch segmentation metrics — counterpart of
``vnet_tpu/ops/metrics.py``: overall accuracy and, for every
non-background class, sensitivity, specificity and dice from the batch's
confusion counts, plus the optional thresholded AUC estimate. Inputs are
``(B, *spatial, C)`` logits and ``(B, *spatial)`` labels; values stay on the
logits' device as 0-d tensors. Under data parallelism the counts are summed
over the ranks before any division (``reduce``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def confusion_counts(pred, labels, num_classes: int):
    """Per-class TP/TN/FP/FN over the whole batch, float32 ``(C,)``."""
    pred_oh = F.one_hot(pred.long(), num_classes).float()
    lbl_oh = F.one_hot(labels.long(), num_classes).float()
    axes = tuple(range(pred_oh.dim() - 1))
    return {"tp": (pred_oh * lbl_oh).sum(axes),
            "fp": (pred_oh * (1.0 - lbl_oh)).sum(axes),
            "fn": ((1.0 - pred_oh) * lbl_oh).sum(axes),
            "tn": ((1.0 - pred_oh) * (1.0 - lbl_oh)).sum(axes)}


def batch_metrics(logits, labels, num_classes: int, compute_auc: bool = False,
                  auc_thresholds: int = 200,
                  reduce: Optional[Callable[[torch.Tensor],
                                            torch.Tensor]] = None):
    """Flat dict of scalars keyed like the JAX function's (class *index*
    suffixes: ``sensitivity_1``, ``dice_2``, ...).

    ``reduce``: sums a flat float32 tensor over data-parallel ranks
    (``Mesh.sum``). Every ratio is taken from global counts: the correct
    voxels and the voxel count, the confusion counts and the AUC's
    per-threshold counts are summed in one call, then divided, so the
    metrics are those of the global batch (a mean of the ranks' ratios
    would not be)."""
    pred = logits.argmax(-1)
    labels = labels.long()
    c = confusion_counts(pred, labels, num_classes)
    parts = [(pred == labels).float().sum().reshape(1),
             torch.full((1,), float(labels.numel()),
                        device=logits.device),
             c["tp"], c["fp"], c["fn"], c["tn"]]
    if compute_auc:
        softmax = torch.softmax(logits.float(), dim=-1)
        lbl_oh = F.one_hot(labels, num_classes).float()
        kepsilon = 1e-7
        ts = torch.cat([
            torch.tensor([0.0 - kepsilon]),
            torch.arange(1, auc_thresholds - 1, dtype=torch.float32)
            / (auc_thresholds - 1),
            torch.tensor([1.0 + kepsilon])]).to(logits.device)
        for i in range(1, num_classes):
            p = softmax[..., i].reshape(-1)
            y = lbl_oh[..., i].reshape(-1)
            pred_pos = (p[None, :] > ts[:, None]).float()
            parts += [(pred_pos * y[None, :]).sum(1),
                      (pred_pos * (1.0 - y[None, :])).sum(1),
                      y.sum().reshape(1), (1.0 - y).sum().reshape(1)]
    sizes = [t.numel() for t in parts]
    flat = torch.cat(parts)
    if reduce is not None:
        flat = reduce(flat)
    correct, voxels, tp, fp, fn, tn, *auc = torch.split(flat, sizes)
    out = {"accuracy": (correct / voxels)[0]}
    eps = 1e-7
    sens = tp / (tp + fn + eps)
    spec = tn / (tn + fp + eps)
    dice = 2.0 * tp / (2.0 * tp + fp + fn + eps)
    for i in range(1, num_classes):  # class 0 skipped
        out[f"sensitivity_{i}"] = sens[i]
        out[f"specificity_{i}"] = spec[i]
        out[f"dice_{i}"] = dice[i]
    for i in range(1, num_classes if compute_auc else 1):  # auc: 4 a class
        tp_t, fp_t, pos, neg = auc[4 * (i - 1):4 * i]
        tpr = tp_t / (pos + eps)
        fpr = fp_t / (neg + eps)
        out[f"auc_{i}"] = ((fpr[:-1] - fpr[1:])
                           * (tpr[:-1] + tpr[1:]) / 2.0).sum()
    return out
