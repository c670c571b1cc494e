"""V-Net, 3D, direct convolutions — counterpart of ``vnet_tpu/models/vnet.py``.

Same topology and parameters as the JAX module (see its docstring):

* input layer: a 1-channel input goes through ``TiledInputBatchNorm``
  (batch kinds) or is tiled to ``num_channels`` and normalised; a
  multichannel input gets a 5^3 conv + norm + activation;
* encoder level l: ``num_convolutions[l]`` x [5^3 conv, residual add of
  the block input at the last conv, norm, act, dropout], then a stride-2
  down-conv doubling channels;
* bottom: ``bottom_convolutions`` more residual convs;
* decoder level l: stride-2 transpose conv halving channels + norm + act,
  concat with the skip, then 5^3 convs 2n -> n with the residual taken
  from the up-convolved features (the JAX package's deliberate change from
  the TF reference, ``vnet_tpu/models/vnet.py:20-24``);
* output: 1^3 conv to ``num_classes``, then a norm **after** the logits.

The JAX package may run its convolutions through the exact space-to-depth
rewrite (``conv_impl="packed"``); the parameters are the same, so the
direct convolutions here take the same weights. Compute runs in ``dtype``
(bfloat16 for ``Precision: bfloat16``) with float32 parameters; logits are
returned in float32.

Training: ``dropout_impl`` selects the dropout flavour of every block's
dropout layers and ``dw_impl`` the weight gradient of every stride-1
convolution (the block convolutions, the multichannel input convolution and
the 1^3 output convolution; ``"pallas"``: the CUDA kernel). The dropout
layers are numbered in module order when the network is built, and
``forward(x, dropout_seed=s)`` keys each layer's mask by ``(s, number)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (Activation, DownConv, Dropout, Norm, SpatialConv,
                     TiledInputBatchNorm, UpConv)


class ConvBlock(nn.Module):
    """n x [5^3 conv -> (+ block input at the last conv) -> norm -> act ->
    dropout]; children ``conv_i``, ``norm_i``, ``act_i``, ``dropout_i``."""

    def __init__(self, num_convolutions: int, channels: int,
                 norm: str = "batch", activation: str = "prelu",
                 dropout_rate: float = 0.0,
                 in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla", dw_impl: str = "xla"):
        super().__init__()
        self.num_convolutions = num_convolutions
        for i in range(num_convolutions):
            cin = (in_channels or channels) if i == 0 else channels
            self.add_module(f"conv_{i + 1}", SpatialConv(
                cin, channels, (5, 5, 5), generator=generator,
                dw_impl=dw_impl))
            self.add_module(f"norm_{i + 1}", Norm(norm, channels))
            self.add_module(f"act_{i + 1}", Activation(activation, channels))
            self.add_module(f"dropout_{i + 1}", Dropout(dropout_rate,
                                                        dropout_impl))

    def _layer(self, x, i, residual):
        x = getattr(self, f"conv_{i + 1}")(x)
        if i == self.num_convolutions - 1:
            x = x + residual
        x = getattr(self, f"norm_{i + 1}")(x)
        x = getattr(self, f"act_{i + 1}")(x)
        return getattr(self, f"dropout_{i + 1}")(x)

    def forward(self, x):
        block_input = x
        for i in range(self.num_convolutions):
            x = self._layer(x, i, block_input)
        return x


class DecoderConvBlock(ConvBlock):
    """Concat the skip, then 5^3 convs 2n -> n, residual from the
    up-convolved input ``x``."""

    def __init__(self, num_convolutions: int, channels: int, **kw):
        super().__init__(num_convolutions, channels,
                         in_channels=2 * channels, **kw)

    def forward(self, x, skip):
        residual = x
        x = torch.cat([x, skip], dim=1)
        for i in range(self.num_convolutions):
            x = self._layer(x, i, residual)
        return x


class VNet(nn.Module):
    """V-Net (https://arxiv.org/abs/1606.04797), 3D.

    ``forward`` takes ``(B, x, y, z, C_in)`` and returns float32 logits
    ``(B, x, y, z, num_classes)``, the JAX layout. Whether batch norms use
    running averages or batch statistics follows ``norm`` and the module's
    train/eval mode (``Norm``). In training mode with dropout,
    ``dropout_seed`` (an int, the step's seed) is required.
    """

    def __init__(self, num_classes: int, in_channels: int = 1,
                 num_channels: int = 16, num_levels: int = 4,
                 num_convolutions: Sequence[int] = (1, 2, 3, 3),
                 bottom_convolutions: int = 3, dropout_rate: float = 0.01,
                 activation: str = "prelu", norm: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla", dw_impl: str = "xla"):
        super().__init__()
        if num_levels != len(num_convolutions):
            raise ValueError("num_convolutions must have num_levels entries")
        self.num_levels = num_levels
        self.dtype = dtype
        self.num_channels = num_channels
        g = generator
        ch = num_channels

        self.tile_input = in_channels == 1
        if self.tile_input:
            self.input_norm = (TiledInputBatchNorm(ch, norm)
                               if norm in ("batch", "batch_stats")
                               else Norm(norm, ch))
        else:
            self.input_conv = SpatialConv(in_channels, ch, (5, 5, 5),
                                          generator=g, dw_impl=dw_impl)
            self.input_norm = Norm(norm, ch)
            self.input_act = Activation(activation, ch)

        block_kw = dict(norm=norm, activation=activation,
                        dropout_rate=dropout_rate, generator=g,
                        dropout_impl=dropout_impl, dw_impl=dw_impl)
        for level in range(num_levels):
            self.add_module(f"encoder_level_{level + 1}", ConvBlock(
                num_convolutions[level], ch, **block_kw))
            self.add_module(f"down_{level + 1}", DownConv(
                ch, 2, norm, activation, generator=g))
            ch *= 2
        self.bottom = ConvBlock(bottom_convolutions, ch, **block_kw)
        for level in reversed(range(num_levels)):
            self.add_module(f"up_{level + 1}", UpConv(
                ch, 2, norm, activation, generator=g))
            ch //= 2
            self.add_module(f"decoder_level_{level + 1}", DecoderConvBlock(
                num_convolutions[level], ch, **block_kw))
        self.output_conv = SpatialConv(ch, num_classes, (1, 1, 1),
                                       generator=g, dw_impl=dw_impl)
        self.output_norm = Norm(norm, num_classes)
        self.dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for index, m in enumerate(self.dropouts):
            m.index = index

    def forward(self, x, dropout_seed: Optional[int] = None):
        for m in self.dropouts:
            m.seed = dropout_seed
        # (B, x, y, z, C) -> logical (B, C, x, y, z), channels-last memory
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)
        if self.tile_input and isinstance(self.input_norm,
                                          TiledInputBatchNorm):
            x = self.input_norm(x)
        elif self.tile_input:
            x = self.input_norm(x.expand(-1, self.num_channels, -1, -1, -1))
        else:
            x = self.input_act(self.input_norm(self.input_conv(x)))
        x = x.contiguous(memory_format=torch.channels_last_3d)

        skips = []
        for level in range(self.num_levels):
            x = getattr(self, f"encoder_level_{level + 1}")(x)
            skips.append(x)
            x = getattr(self, f"down_{level + 1}")(x)
        x = self.bottom(x)
        for level in reversed(range(self.num_levels)):
            x = getattr(self, f"up_{level + 1}")(x)
            x = getattr(self, f"decoder_level_{level + 1}")(x, skips[level])

        logits = self.output_norm(self.output_conv(x))
        return logits.float().permute(0, 2, 3, 4, 1)
