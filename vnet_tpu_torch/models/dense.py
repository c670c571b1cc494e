"""Dense (MLP) segmentation head — counterpart of
``vnet_tpu/models/dense.py``: flatten -> norm -> ``num_levels`` x
[dense(``hidden_units``) -> act -> norm -> dropout] -> dense(voxels x
classes) -> reshape to logits, 2D or 3D.

The input is flattened in the JAX layout's order ``(B, *spatial, C)``, so
the first kernel's rows are JAX's. The norms see ``(B, F)`` tensors
(``Norm`` reduces batch kinds over the batch). Dense kernels initialise as
flax's ``lecun_normal`` (a unit normal truncated to +-2, rescaled to
variance ``1 / fan_in``), biases zero; they are stored as ``nn.Linear``
stores them, ``(out, in)`` (``convert.py`` transposes JAX's ``(in,
out)``), and cast to the compute dtype at use. Dropout is flax's
``nn.Dropout``: the port's ``xla`` flavour, keyed by the layer's number and
the step's seed. The output layer has one unit per voxel and class, so the
network takes patches of the ``patch_shape`` it was built for.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Activation, Dropout, Norm

# stddev of a unit normal truncated to [-2, 2], which flax divides out
_TRUNCATED_UNIT_STDDEV = 0.87962566103423978


class Linear(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute dtype;
    ``weight`` ``(out, in)``."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            self.weight.mul_(math.sqrt(1.0 / in_features)
                             / _TRUNCATED_UNIT_STDDEV)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Dense(nn.Module):

    def __init__(self, num_classes: int, patch_shape: Sequence[int],
                 in_channels: int = 1, num_levels: int = 2,
                 hidden_units: int = 128, dropout_rate: float = 0.01,
                 activation: str = "relu", norm: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_shape = tuple(int(s) for s in patch_shape)
        self.num_classes = num_classes
        self.num_levels = num_levels
        self.dtype = dtype
        voxels = math.prod(self.patch_shape)
        features = voxels * in_channels
        self.input_norm = Norm(norm, features)
        for i in range(num_levels):
            self.add_module(f"dense_{i + 1}", Linear(
                features if i == 0 else hidden_units, hidden_units,
                generator))
            self.add_module(f"act_{i + 1}", Activation(activation,
                                                       hidden_units))
            self.add_module(f"norm_{i + 1}", Norm(norm, hidden_units))
            self.add_module(f"dropout_{i + 1}", Dropout(dropout_rate,
                                                        index=i))
        self.output_dense = Linear(hidden_units, voxels * num_classes,
                                   generator)
        self.dropouts = [getattr(self, f"dropout_{i + 1}")
                         for i in range(num_levels)]

    def forward(self, x, dropout_seed: Optional[int] = None):
        for m in self.dropouts:
            m.seed = dropout_seed
        spatial = tuple(x.shape[1:-1])
        if spatial != self.patch_shape:
            raise ValueError(f"Dense was built for patches "
                             f"{self.patch_shape}, got {spatial}")
        batch = x.shape[0]
        x = self.input_norm(x.to(self.dtype).reshape(batch, -1))
        for i in range(self.num_levels):
            for part in ("dense", "act", "norm", "dropout"):
                x = getattr(self, f"{part}_{i + 1}")(x)
        logits = self.output_dense(x)
        return logits.reshape((batch,) + spatial
                              + (self.num_classes,)).float()
