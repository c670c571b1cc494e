"""Segmentation losses — counterpart of ``vnet_tpu/ops/losses.py``.

The ten names of the reference's loss zoo: soft Sørensen/Jaccard dice with
optional per-class weights (the weighted form sums the weighted numerators
and denominators over classes, ``sum(2*w*inse + s) / sum(w*(l + r) + s)``,
smooth 1e-5), class-weighted and plain softmax cross entropy, and their
``mixed_*`` sums. Everything is computed in float32 from ``(B, *spatial,
C)`` logits and ``(B, *spatial)`` integer labels, the JAX layout, and
returns ``(loss, aux)`` with the same aux keys as the JAX function.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

LOSS_NAMES = (
    "xent", "weighted_xent",
    "sorensen", "weighted_sorensen",
    "jaccard", "weighted_jaccard",
    "mixed_sorensen", "mixed_weighted_sorensen",
    "mixed_jaccard", "mixed_weighted_jaccard",
)


def dice_coe(output, target, loss_type: str = "jaccard", axis=(1, 2, 3),
             weights: Sequence[float] = (), smooth: float = 1e-5):
    """Soft dice coefficient (1 = perfect overlap), batch mean."""
    output = output.float()
    target = target.float()
    axis = tuple(axis)
    inse = torch.sum(output * target, dim=axis)
    if loss_type == "jaccard":
        l = torch.sum(output * output, dim=axis)
        r = torch.sum(target * target, dim=axis)
    elif loss_type == "sorensen":
        l = torch.sum(output, dim=axis)
        r = torch.sum(target, dim=axis)
    else:
        raise ValueError(f"Unknown loss_type: {loss_type!r}")
    if len(weights):
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=output.device)
        dice = (torch.sum(2.0 * w * inse + smooth, dim=-1)
                / torch.sum(w * (l + r) + smooth, dim=-1))
        return dice.mean()
    return ((2.0 * inse + smooth) / (l + r + smooth)).mean()


def softmax_cross_entropy(labels_onehot, logits):
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-(labels_onehot.float() * logp).sum(-1)).mean()


def weighted_softmax_cross_entropy(labels_onehot, logits, weights):
    """Per-voxel weight = the weight of the voxel's true class."""
    onehot = labels_onehot.float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=logits.device)
    voxel_w = (w * onehot).sum(-1)
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-(onehot * logp).sum(-1) * voxel_w).mean()


def segmentation_loss(logits, labels, *, name: str, num_classes: int,
                      weights: Sequence[float] = (), alpha: float = 1.0):
    """``(loss, aux)`` of loss ``name`` (one of ``LOSS_NAMES``); aux holds
    ``total_loss`` and, for ``mixed_*``, ``dice`` and ``regularized_xent``."""
    if name not in LOSS_NAMES:
        raise ValueError(f"Invalid loss function: {name!r}")
    spatial_axes = tuple(range(1, labels.dim()))
    onehot = F.one_hot(labels.long(), num_classes).float()
    softmax = torch.softmax(logits.float(), dim=-1)
    aux = {}

    def _dice(loss_type, weighted):
        return dice_coe(softmax, onehot, loss_type=loss_type,
                        axis=spatial_axes,
                        weights=weights if weighted else ())

    if name == "xent":
        loss = softmax_cross_entropy(onehot, logits)
    elif name == "weighted_xent":
        loss = weighted_softmax_cross_entropy(onehot, logits, weights)
    elif name in ("sorensen", "weighted_sorensen"):
        loss = 1.0 - _dice("sorensen", name.startswith("weighted"))
    elif name in ("jaccard", "weighted_jaccard"):
        loss = 1.0 - _dice("jaccard", name.startswith("weighted"))
    else:  # mixed_*
        weighted = "weighted" in name
        loss_type = "sorensen" if "sorensen" in name else "jaccard"
        xent = (weighted_softmax_cross_entropy(onehot, logits, weights)
                if weighted else softmax_cross_entropy(onehot, logits))
        dice_loss = 1.0 - _dice(loss_type, weighted)
        aux["dice"] = dice_loss
        aux["regularized_xent"] = alpha * xent
        loss = dice_loss + alpha * xent
    aux["total_loss"] = loss
    return loss, aux
