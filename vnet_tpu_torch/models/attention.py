"""Attention-gated V-Net — counterpart of ``vnet_tpu/models/attention.py``.

* ``ResidualAttentionBlock``: 3^3 conv + norm + act + dropout, 3^3 conv +
  norm, a 1^3-conv shortcut, add, norm, act, dropout.
* ``AttentionModule``: three residual blocks, then a 1^3 conv + norm to
  ``num_classes``; trained to regress a distance map of the label
  (:func:`attention_distance_loss`).
* ``OutputModule``: the same head, applied to the gated logits.
* ``AttentionGatedVNet``: a ``VNet`` backbone, the gate ``masked = (1 +
  softmax(attention)) * logits`` over the class axis, and the output
  module. ``forward`` returns ``(logits, attention_logits)``, both float32
  in the JAX layout ``(B, x, y, z, num_classes)``.

Sub-module names mirror the flax paths (``vnet``, ``attention``,
``output_module``, ``resblock_{i}``, ``shortcut_conv``, ``conv_1``,
``norm_1``, ``act_1``, ``conv_2``, ``norm_2``, ``norm_out``, ``act_out``,
``output_conv``, ``output_norm``), so ``convert.py`` maps the weights by
path. The heads' convolutions are plain SAME ``F.conv3d`` (flax ``nn.Conv``
outside any Pallas kernel in JAX, so never the dW kernel), float32
parameters cast to the compute dtype at use, kernels initialised from a
truncated normal of stddev 0.1 (flax's ``truncated_normal``: cut at +-2
sigma of the unit normal, rescaled by 1 / 0.87962566) and zero biases. The
heads use ReLU, as the JAX heads' default. Every dropout layer runs the
port's ``Dropout`` (the CUDA kernel on the card); the layers are numbered
across the whole network when it is built, the backbone's first, so each
has its own stream.

``remat`` recomputes the attention and output modules in the backward
pass and passes ``remat`` to the backbone, which recomputes its conv
blocks (``vnet_tpu/models/attention.py:166-203``; ``layers.recomputed``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import Activation, Dropout, Norm, SpatialConv, recomputed
from .vnet import VNet

TRUNCATED_NORMAL_STDDEV = 0.1
# stddev of a unit normal truncated to [-2, 2], which flax divides out
_TRUNCATED_UNIT_STDDEV = 0.87962566103423978


def _att_conv(in_features: int, features: int, kernel: int,
              generator: Optional[torch.Generator]) -> SpatialConv:
    """SAME conv with flax's ``truncated_normal(stddev=0.1)`` kernel and a
    zero bias."""
    conv = SpatialConv(in_features, features, (kernel,) * 3,
                       generator=generator)
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        conv.weight.mul_(TRUNCATED_NORMAL_STDDEV / _TRUNCATED_UNIT_STDDEV)
    return conv


def _to_port(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """JAX-layout ``(B, x, y, z, C)`` -> logical ``(B, C, x, y, z)``,
    channels-last in memory, in ``dtype``."""
    return x.to(dtype).permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)


class ResidualAttentionBlock(nn.Module):

    def __init__(self, in_features: int, features: int,
                 output_activation: bool = True, norm: str = "batch",
                 activation: str = "relu", dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla"):
        super().__init__()
        self.shortcut_conv = _att_conv(in_features, features, 1, generator)
        self.conv_1 = _att_conv(in_features, features, 3, generator)
        self.norm_1 = Norm(norm, features)
        self.act_1 = Activation(activation, features)
        self.dropout_1 = Dropout(dropout_rate, dropout_impl)
        self.conv_2 = _att_conv(features, features, 3, generator)
        self.norm_2 = Norm(norm, features)
        self.norm_out = Norm(norm, features)
        self.act_out = (Activation(activation, features)
                        if output_activation else None)
        self.dropout_2 = Dropout(dropout_rate, dropout_impl)

    def forward(self, x):
        shortcut = self.shortcut_conv(x)
        y = self.dropout_1(self.norm_1(self.conv_1(x), act=self.act_1))
        y = self.norm_2(self.conv_2(y))
        return self.dropout_2(self.norm_out(y + shortcut, act=self.act_out))


class AttentionModule(nn.Module):
    """Residual blocks, then a 1^3 conv + norm to ``num_classes``; takes
    and returns the JAX layout, float32 out."""

    def __init__(self, in_features: int, num_classes: int,
                 num_channels: int = 64, num_blocks: int = 3,
                 norm: str = "batch", activation: str = "relu",
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"resblock_{i + 1}", ResidualAttentionBlock(
                in_features if i == 0 else num_channels, num_channels, True,
                norm, activation, dropout_rate, generator, dropout_impl))
        self.output_conv = _att_conv(num_channels, num_classes, 1, generator)
        self.output_norm = Norm(norm, num_classes)

    def forward(self, x):
        x = _to_port(x, self.dtype)
        for i in range(self.num_blocks):
            x = getattr(self, f"resblock_{i + 1}")(x)
        logits = self.output_norm(self.output_conv(x))
        return logits.float().permute(0, 2, 3, 4, 1)


class OutputModule(AttentionModule):
    """The same head as :class:`AttentionModule`, on the gated logits."""


class AttentionGatedVNet(nn.Module):
    """V-Net backbone + attention gate + output refinement. ``conv_impl``,
    ``packed_target_lanes``, ``legacy_double_norm`` and ``dw_impl`` go to
    the backbone (``vnet_tpu/models/attention.py:174-190``); the heads'
    convolutions stay direct, as JAX's ``nn.Conv`` heads are. ``remat``
    goes to the backbone and recomputes both heads."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 num_channels: int = 16, num_levels: int = 4,
                 num_convolutions: Sequence[int] = (1, 2, 3, 3),
                 bottom_convolutions: int = 3, attention_channels: int = 64,
                 dropout_rate: float = 0.01, activation: str = "prelu",
                 norm: str = "batch", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla", dw_impl: str = "xla",
                 conv_impl: str = "direct", packed_target_lanes: int = 0,
                 legacy_double_norm: bool = False, remat: bool = False):
        super().__init__()
        self.norm = norm
        self.remat = remat
        self.vnet = VNet(num_classes=num_classes, in_channels=in_channels,
                         num_channels=num_channels, num_levels=num_levels,
                         num_convolutions=num_convolutions,
                         bottom_convolutions=bottom_convolutions,
                         dropout_rate=dropout_rate, activation=activation,
                         norm=norm, dtype=dtype, generator=generator,
                         dropout_impl=dropout_impl, dw_impl=dw_impl,
                         conv_impl=conv_impl,
                         packed_target_lanes=packed_target_lanes,
                         legacy_double_norm=legacy_double_norm, remat=remat)
        head = dict(num_channels=attention_channels, norm=norm,
                    dropout_rate=dropout_rate, dtype=dtype,
                    generator=generator, dropout_impl=dropout_impl)
        self.attention = AttentionModule(num_classes, num_classes, **head)
        self.output_module = OutputModule(num_classes, num_classes, **head)
        self.dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for index, m in enumerate(self.dropouts):
            m.index = index

    def forward(self, x, dropout_seed: Optional[int] = None):
        for m in self.dropouts:
            m.seed = dropout_seed
        logits_vnet = self.vnet(x, dropout_seed=dropout_seed)
        attention_logits = recomputed(self.attention, logits_vnet,
                                      enabled=self.remat)
        gate = 1.0 + torch.softmax(attention_logits, dim=-1)
        logits = recomputed(self.output_module, gate * logits_vnet,
                            enabled=self.remat)
        return logits, attention_logits


def attention_distance_loss(attention_logits: torch.Tensor,
                            distance_map: torch.Tensor, kind: str = "l2",
                            scale: float = 100.0) -> torch.Tensor:
    """Distance-map supervision of the gate: L2 (times ``scale``) or L1
    between the attention softmax and a normalised distance map; a map
    without a class axis is compared with every foreground channel."""
    att = torch.softmax(attention_logits.float(), dim=-1)
    target = distance_map.float()
    if target.dim() == att.dim() - 1:
        att = att[..., 1:]
        target = target[..., None].expand_as(att)
    if kind == "l2":
        return scale * torch.mean((att - target) ** 2)
    if kind == "abs":
        return torch.mean(torch.abs(att - target))
    raise ValueError(f"Unknown attention loss kind: {kind!r}")
