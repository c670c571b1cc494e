"""Plain PyTorch reference of ``attention3d_mm``: the attention-gated V-Net
of ``configs/config_attention_multimodal.json`` (the same V-Net backbone
as ``vnet3d_liver``, two input modalities), its mixed Sørensen loss and
the gate's distance-map loss.

Two heads of the same form follow the backbone's logits: ``attention``
reads them, ``output_module`` reads ``(1 + softmax(attention)) *
logits``. A head is ``attention_blocks`` residual blocks of
``attention_channels`` (a 1^3 shortcut conv; 3^3 conv, batch norm, ReLU,
dropout; 3^3 conv, batch norm; the sum batch-normalised, ReLU, dropout),
then a 1^3 conv and a batch norm to the classes. The loss is ``1 -
dice + alpha * cross entropy`` of the output module's logits plus
``scale * mean((softmax(attention)[..., 1:] - distance map)^2)``. The
dropout layers are numbered after the backbone's, in module order.
Precision, checkpointing and parameter naming as in ``vnet3d_liver``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import vnet3d_liver as base
from portbench.reference.vnet3d_liver import (Ctx, batch_norm, conv,
                                              dropout, run)
from portbench.yardstick import flops

HEADS = ("attention", "output_module")
strict_float32 = base.strict_float32
train = base.train
params_only = base.params_only


def _head_shapes(net: dict, head: str) -> List[Tuple[str, tuple]]:
    classes, width = int(net["num_classes"]), int(net["attention_channels"])
    out, cin = [], classes
    for i in range(int(net["attention_blocks"])):
        blk = f"{head}.resblock_{i + 1}"
        out += base._conv(f"{blk}.shortcut_conv", width, cin, 1)
        out += base._conv(f"{blk}.conv_1", width, cin, 3)
        out += base._bn(f"{blk}.norm_1", width)
        out += base._conv(f"{blk}.conv_2", width, width, 3)
        out += base._bn(f"{blk}.norm_2", width)
        out += base._bn(f"{blk}.norm_out", width)
        cin = width
    out += base._conv(f"{head}.output_conv", classes, width, 1)
    out += base._bn(f"{head}.output_norm", classes)
    return out


def named_shapes(net: dict) -> List[Tuple[str, tuple]]:
    out = base.named_shapes(net, prefix="vnet.")
    for head in HEADS:
        out += _head_shapes(net, head)
    return out


def dropout_layers(net: dict) -> List[str]:
    out = ["vnet." + n for n in base.dropout_layers(net)]
    for head in HEADS:
        for i in range(int(net["attention_blocks"])):
            out += [f"{head}.resblock_{i + 1}.dropout_{j}" for j in (1, 2)]
    return out


def layer_shapes(net: dict, batch: int, patch) -> Dict[str, tuple]:
    out = {"vnet." + k: v
           for k, v in base.layer_shapes(net, batch, patch).items()}
    for head in HEADS:
        for i in range(int(net["attention_blocks"])):
            for j in (1, 2):
                out[f"{head}.resblock_{i + 1}.dropout_{j}"] = (
                    (batch, *patch, int(net["attention_channels"])), None)
    return out


class _Prefixed(dict):
    """The parameters seen from the backbone: ``name`` is ``vnet.name``."""

    def __init__(self, P):
        super().__init__()
        self.P = P

    def __getitem__(self, k):
        return self.P["vnet." + k]


def _resblock(ctx: Ctx, blk: str, x):
    shortcut = conv(ctx, f"{blk}.shortcut_conv", x)
    y = F.relu(batch_norm(ctx, f"{blk}.norm_1", conv(ctx, f"{blk}.conv_1",
                                                     x)))
    y = dropout(ctx, f"{blk}.dropout_1", y)
    y = batch_norm(ctx, f"{blk}.norm_2", conv(ctx, f"{blk}.conv_2", y))
    out = F.relu(batch_norm(ctx, f"{blk}.norm_out", y + shortcut))
    return dropout(ctx, f"{blk}.dropout_2", out)


def _head_out(ctx: Ctx, head: str, x):
    return batch_norm(ctx, f"{head}.output_norm",
                      conv(ctx, f"{head}.output_conv", x))


def head(ctx: Ctx, net: dict, name: str, x):
    """A head on JAX-layout ``x``; JAX-layout logits."""
    x = x.permute(0, 4, 1, 2, 3)
    for i in range(int(net["attention_blocks"])):
        x = run(ctx, _resblock, f"{name}.resblock_{i + 1}", x)
    return run(ctx, _head_out, name, x).permute(0, 2, 3, 4, 1)


def network(ctx: Ctx, net: dict, x):
    """``(logits, attention_logits)`` of ``x`` ``(B, X, Y, Z, C)``."""
    inner = Ctx(_Prefixed(ctx.P), ctx.mode, ctx.q,
                {k[5:]: v for k, v in ctx.masks.items()
                 if k.startswith("vnet.")}, ctx.keep, ctx.ckpt)
    logits_vnet = base.vnet(inner, net, x)
    att = head(ctx, net, "attention", logits_vnet)
    gate = 1.0 + torch.softmax(att, dim=-1)
    return head(ctx, net, "output_module", gate * logits_vnet), att


def loss(logits, att, batch: dict, settings: dict):
    net, lcfg = settings["network"], settings["loss"]
    classes = int(net["num_classes"])
    onehot = F.one_hot(batch["labels"].long(), classes).to(logits.dtype)
    xent = (-(onehot * F.log_softmax(logits, dim=-1)).sum(-1)).mean()
    value = base.dice_loss(logits, batch["labels"], classes) + (
        lcfg["alpha"] * xent)
    a = torch.softmax(att, dim=-1)[..., 1:]
    target = batch["distance_maps"][..., None].expand_as(a)
    return value + lcfg["attention_scale"] * torch.mean((a - target) ** 2)


def forward_loss(settings: dict):
    net = settings["network"]

    def fn(P, batch, seed, q):
        device = batch["images"].device
        shapes = layer_shapes(net, batch["images"].shape[0],
                              batch["images"].shape[1:4])
        m = base.masks(dropout_layers(net), shapes, seed, net["dropout"],
                       device)
        ctx = Ctx(P, "train", q, m, 1.0 - net["dropout"], ckpt=True)
        logits, att = network(ctx, net, batch["images"])
        return loss(logits, att, batch, settings)
    return fn


def head_flops_per_voxel(net: dict) -> Fraction:
    """Forward FLOPs per voxel of one head: ``attention_blocks``
    residual blocks (a ``1^3`` shortcut and two ``3^3`` convolutions) of
    ``attention_channels``, then a ``1^3`` convolution to the classes."""
    classes, width = int(net["num_classes"]), int(net["attention_channels"])
    total = Fraction(0)
    cin = classes
    for _ in range(int(net["attention_blocks"])):
        total += (flops.conv(1, cin, width) + flops.conv(3, cin, width)
                  + flops.conv(3, width, width))
        cin = width
    return total + flops.conv(1, width, classes)


def flops_per_voxel(net: dict) -> Fraction:
    """The whole network's forward FLOPs per input voxel: the backbone and
    its two heads."""
    return base.flops_per_voxel(net) + 2 * head_flops_per_voxel(net)
