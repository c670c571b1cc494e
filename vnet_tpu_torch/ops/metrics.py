"""Per-batch segmentation metrics — counterpart of
``vnet_tpu/ops/metrics.py``: overall accuracy and, for every
non-background class, sensitivity, specificity and dice from the batch's
confusion counts, plus the optional thresholded AUC estimate. Inputs are
``(B, *spatial, C)`` logits and ``(B, *spatial)`` labels; values stay on the
logits' device as 0-d tensors.
"""

from __future__ import annotations

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
                  auc_thresholds: int = 200):
    """Flat dict of scalars keyed like the JAX function's (class *index*
    suffixes: ``sensitivity_1``, ``dice_2``, ...)."""
    pred = logits.argmax(-1)
    labels = labels.long()
    out = {"accuracy": (pred == labels).float().mean()}
    c = confusion_counts(pred, labels, num_classes)
    eps = 1e-7
    sens = c["tp"] / (c["tp"] + c["fn"] + eps)
    spec = c["tn"] / (c["tn"] + c["fp"] + eps)
    dice = 2.0 * c["tp"] / (2.0 * c["tp"] + c["fp"] + c["fn"] + eps)
    for i in range(1, num_classes):  # class 0 skipped
        out[f"sensitivity_{i}"] = sens[i]
        out[f"specificity_{i}"] = spec[i]
        out[f"dice_{i}"] = dice[i]
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
            tp = (pred_pos * y[None, :]).sum(1)
            fp = (pred_pos * (1.0 - y[None, :])).sum(1)
            tpr = tp / (y.sum() + eps)
            fpr = fp / ((1.0 - y).sum() + eps)
            out[f"auc_{i}"] = ((fpr[:-1] - fpr[1:])
                               * (tpr[:-1] + tpr[1:]) / 2.0).sum()
    return out
