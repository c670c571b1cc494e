"""U-Net, 2D or 3D — counterpart of ``vnet_tpu/models/unet.py``.

Same topology and parameters as the JAX module: encoder levels of
``num_convolutions`` x [3^r conv -> norm -> act -> dropout] with
``num_channels * 2^level`` features, 2^r max pooling (VALID), a bottom
block at ``num_channels * 2^num_levels``, decoder levels of a stride-2
transpose conv halving channels + norm + act, concat with the skip, a norm
of the concat (``concat_norm``), then the conv block; a 1^r output conv and
a norm after the logits. The activation defaults to ReLU (the reference
hardcodes it); dropout is flax's ``nn.Dropout``, so the port's ``xla``
flavour, each layer keyed by its number in module order and the step's
seed (``forward(x, dropout_seed=s)``).

``conv_impl`` ``"s2d"``/``"auto"`` runs the up-convolutions as the matrix
product of ``ops/s2d.py::s2d_up_conv``; the 3^r convolutions stay direct
(JAX's ``can_s2d`` takes kernels of 5 and more) and ``"packed"`` is
``"direct"`` for this network, as in JAX (``unet.py:110``). ``forward``
takes and returns the JAX layout, logits float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Activation, Dropout, Norm, SpatialConv, UpConv

_MEMORY_FORMAT = {2: torch.channels_last, 3: torch.channels_last_3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}


class UNetConvBlock(nn.Module):
    """n x [3^r conv -> norm -> act -> dropout]; children ``conv_i``,
    ``norm_i``, ``act_i``, ``dropout_i``."""

    def __init__(self, in_features: int, features: int,
                 num_convolutions: int, norm: str = "batch",
                 activation: str = "relu", dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 impl: str = "direct", rank: int = 3):
        super().__init__()
        self.num_convolutions = num_convolutions
        for i in range(num_convolutions):
            self.add_module(f"conv_{i + 1}", SpatialConv(
                in_features if i == 0 else features, features, (3,) * rank,
                generator=generator, impl=impl))
            self.add_module(f"norm_{i + 1}", Norm(norm, features))
            self.add_module(f"act_{i + 1}", Activation(activation, features))
            self.add_module(f"dropout_{i + 1}", Dropout(dropout_rate))

    def forward(self, x):
        for i in range(self.num_convolutions):
            for part in ("conv", "norm", "act", "dropout"):
                x = getattr(self, f"{part}_{i + 1}")(x)
        return x


class UNetDecoderBlock(UNetConvBlock):
    """Concat the skip, norm the concat (``concat_norm``), then the conv
    block 2n -> n."""

    def __init__(self, features: int, num_convolutions: int,
                 norm: str = "batch", **kw):
        super().__init__(2 * features, features, num_convolutions, norm,
                         **kw)
        self.concat_norm = Norm(norm, 2 * features)

    def forward(self, x, skip):
        return super().forward(self.concat_norm(torch.cat([x, skip], dim=1)))


class UNet(nn.Module):
    """U-Net (https://arxiv.org/abs/1505.04597), 2D or 3D."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 num_channels: int = 4, num_levels: int = 4,
                 num_convolutions: int = 2, bottom_convolutions: int = 2,
                 dropout_rate: float = 0.01, activation: str = "relu",
                 norm: str = "batch", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 conv_impl: str = "direct", spatial_rank: int = 3):
        super().__init__()
        if spatial_rank not in _MEMORY_FORMAT:
            raise ValueError(f"spatial_rank must be 2 or 3, got "
                             f"{spatial_rank}")
        self.spatial_rank = rank = spatial_rank
        self.num_levels = num_levels
        self.dtype = dtype
        impl = "auto" if conv_impl in ("s2d", "auto") else "direct"
        block = dict(norm=norm, activation=activation,
                     dropout_rate=dropout_rate, generator=generator,
                     impl=impl, rank=rank)
        cin = in_channels
        for level in range(num_levels):
            ch = num_channels * 2 ** level
            self.add_module(f"encoder_level_{level + 1}", UNetConvBlock(
                cin, ch, num_convolutions, **block))
            cin = ch
        ch = num_channels * 2 ** num_levels
        self.bottom = UNetConvBlock(cin, ch, bottom_convolutions, **block)
        for level in reversed(range(num_levels)):
            self.add_module(f"up_{level + 1}", UpConv(
                ch, 2, norm, activation, generator=generator, rank=rank,
                impl=impl))
            ch //= 2
            self.add_module(f"decoder_level_{level + 1}", UNetDecoderBlock(
                ch, num_convolutions, **block))
        self.output_conv = SpatialConv(ch, num_classes, (1,) * rank,
                                       generator=generator)
        self.output_norm = Norm(norm, num_classes)
        self.dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for index, m in enumerate(self.dropouts):
            m.index = index

    def forward(self, x, dropout_seed: Optional[int] = None):
        for m in self.dropouts:
            m.seed = dropout_seed
        rank = self.spatial_rank
        x = x.to(self.dtype).permute(0, rank + 1, *range(1, rank + 1))
        x = x.contiguous(memory_format=_MEMORY_FORMAT[rank])
        skips = []
        for level in range(self.num_levels):
            x = getattr(self, f"encoder_level_{level + 1}")(x)
            skips.append(x)
            x = _MAX_POOL[rank](x, 2, 2)
        x = self.bottom(x)
        for level in reversed(range(self.num_levels)):
            x = getattr(self, f"up_{level + 1}")(x)
            x = getattr(self, f"decoder_level_{level + 1}")(x, skips[level])
        logits = self.output_norm(self.output_conv(x))
        return logits.float().permute(0, *range(2, rank + 2), 1)
