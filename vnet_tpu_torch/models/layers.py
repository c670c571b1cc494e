"""Layer primitives of the V-Net, 3D, direct convolutions.

Counterpart of ``vnet_tpu/models/layers.py``. Tensors inside the network
are logically ``(B, C, x, y, z)`` and physically channels-last
(``torch.channels_last_3d``), the layout the JAX package keeps as
``(B, x, y, z, C)``; the public entry points (``VNet.forward``) take and
return the JAX layout.

Sub-module names mirror the flax variable paths (``conv_1``, ``norm_1.bn``,
``act_1.prelu``) so that ``vnet_tpu_torch/convert.py`` maps weights
mechanically. Leaf parameters use PyTorch's names: ``weight``/``bias`` for
convolutions (``(O, I, kx, ky, kz)``; transpose convolutions
``(I, O, kx, ky, kz)``), ``weight``/``bias`` and the buffers
``running_mean``/``running_var`` for batch norm, ``weight`` for PReLU's
per-channel slope.

Numerics follow flax: BatchNorm momentum 0.99 and epsilon 1e-3, statistics
in float32 as ``E[x^2] - E[x]^2`` (clipped at 0), the running variance is
the biased one. Parameters stay float32 and are cast to the compute dtype
(``x.dtype``) at use, as the JAX modules do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

NORM_KINDS = ("batch", "batch_stats", "group", "instance", "none")
ACTIVATIONS = ("relu", "prelu", "lrelu")

_EPS = 1e-3


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over ``(B, C, *spatial)``."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: Optional[torch.Generator]) -> None:
    """flax ``glorot_uniform`` (Xavier uniform, the reference's conv init)."""
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-lim, lim, generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(lo, hi) padding of XLA's ``"SAME"`` for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class PReLU(nn.Module):
    """Per-channel parametric ReLU, slope initialised to 0.1; computed as
    ``max(x, 0) + alpha * min(x, 0)`` in the compute dtype, as JAX does."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.1))

    def forward(self, x):
        alpha = _channel_view(self.weight.to(x.dtype), x.ndim)
        return torch.clamp_min(x, 0) + alpha * torch.clamp_max(x, 0)


class Activation(nn.Module):
    """String-dispatched activation; PReLU lives in the ``prelu`` child."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ACTIVATIONS:
            raise ValueError(f"Unknown activation: {kind!r}")
        self.kind = kind
        if kind == "prelu":
            self.prelu = PReLU(features)

    def forward(self, x):
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "lrelu":
            return F.leaky_relu(x, 0.01)  # flax nn.leaky_relu default
        return self.prelu(x)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis.

    ``use_running_average`` selects the stored statistics; otherwise the
    statistics of the batch itself are used. This slice is inference only,
    so the running averages are never updated here.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, use_running_average: bool):
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0,) + tuple(range(2, x.ndim))
            mean = xf.mean(axes)
            var = torch.clamp_min(xf.square().mean(axes) - mean.square(), 0.0)
        mul = torch.rsqrt(var + _EPS) * self.weight
        y = ((xf - _channel_view(mean, x.ndim)) * _channel_view(mul, x.ndim)
             + _channel_view(self.bias, x.ndim))
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (per sample and group, float32 statistics)."""

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.float().reshape((b, g, c // g) + tuple(x.shape[2:]))
        axes = tuple(range(2, xg.ndim))
        mean = xg.mean(axes, keepdim=True)
        var = torch.clamp_min(xg.square().mean(axes, keepdim=True)
                              - mean.square(), 0.0)
        mul = torch.rsqrt(var + _EPS)
        y = ((xg - mean) * mul).reshape(x.shape)
        y = (y * _channel_view(self.weight, x.ndim)
             + _channel_view(self.bias, x.ndim))
        return y.to(x.dtype)


class Norm(nn.Module):
    """Normalisation selected by ``kind`` (see ``vnet_tpu/models/layers.py``).

    ``batch``: running averages in eval mode, batch statistics in train
    mode. ``batch_stats``: batch statistics in every mode (the reference
    evaluates with ``train_phase=True``). ``group``: up to 8 groups.
    ``instance``: per-sample spatial statistics, then a per-channel affine
    held on this module itself (as in flax). ``none``: identity.
    """

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in NORM_KINDS:
            raise ValueError(f"Unknown norm kind: {kind!r}")
        self.kind = kind
        if kind in ("batch", "batch_stats"):
            self.bn = BatchNorm(features)
        elif kind == "group":
            groups = min(8, features)
            while features % groups:
                groups -= 1
            self.gn = GroupNorm(features, groups)
        elif kind == "instance":
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.kind == "none":
            return x
        if self.kind in ("batch", "batch_stats"):
            return self.bn(x, self.kind == "batch" and not self.training)
        if self.kind == "group":
            return self.gn(x)
        xf = x.float()
        axes = tuple(range(2, x.ndim))
        mean = xf.mean(axes, keepdim=True)
        var = xf.square().mean(axes, keepdim=True) - mean.square()
        y = ((xf - mean) * torch.rsqrt(var + _EPS)).to(x.dtype)
        return (y * _channel_view(self.weight.to(x.dtype), x.ndim)
                + _channel_view(self.bias.to(x.dtype), x.ndim))


class TiledInputBatchNorm(nn.Module):
    """Fused ``tile(1 -> C) + BatchNorm`` of the V-Net input layer.

    Every tiled channel holds the same data, so the batch statistics are
    the statistics of the single input channel: normalise it once and
    broadcast through the per-channel affine, in the compute dtype. The
    variables sit in the ``bn`` child, as in ``Norm``.
    """

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind not in ("batch", "batch_stats"):
            raise ValueError(f"TiledInputBatchNorm needs a batch kind, "
                             f"got {kind!r}")
        self.kind = kind
        self.bn = BatchNorm(features)

    def forward(self, x1):
        if x1.shape[1] != 1:
            raise ValueError(f"expected one input channel, got {x1.shape}")
        bn = self.bn
        c = bn.weight.shape[0]
        if self.kind == "batch" and not self.training:
            mean, var = bn.running_mean, bn.running_var
        else:
            xf = x1.float()
            mu = xf.mean()
            var_s = xf.square().mean() - mu.square()
            mean, var = mu.expand(c), var_s.expand(c)
        inv = torch.rsqrt(var + _EPS) * bn.weight
        shift = bn.bias - mean * inv
        return (x1 * _channel_view(inv.to(x1.dtype), x1.ndim)
                + _channel_view(shift.to(x1.dtype), x1.ndim))


class SpatialConv(nn.Module):
    """3D convolution with XLA ``"SAME"`` padding, direct mode only.

    ``weight`` is ``(out, in, kx, ky, kz)``; Xavier-uniform init, zero bias.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        self.weight = nn.Parameter(
            torch.empty((features, in_features) + self.kernel_size))
        rf = math.prod(self.kernel_size)
        _glorot_uniform_(self.weight, rf * in_features, rf * features,
                         generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        pads = [same_pads(n, k, s) for n, k, s in
                zip(x.shape[2:], self.kernel_size, self.strides)]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.strides, padding)


class SpatialConvTranspose(nn.Module):
    """``lax.conv_transpose(..., "SAME")`` with kernel == stride (the
    V-Net's up-convolution), output ``stride * input``.

    ``weight`` is ``(in, out, kx, ky, kz)`` as ``F.conv_transpose3d`` takes
    it. ``lax.conv_transpose`` does not flip the kernel and PyTorch's
    transpose convolution is the adjoint of a convolution, so the JAX
    kernel maps here spatially flipped (``convert.py``).
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        if self.kernel_size != self.strides:
            raise NotImplementedError(
                "SpatialConvTranspose supports kernel == stride only "
                f"(got kernel {self.kernel_size}, stride {self.strides})")
        self.weight = nn.Parameter(
            torch.empty((in_features, features) + self.kernel_size))
        rf = math.prod(self.kernel_size)
        _glorot_uniform_(self.weight, rf * in_features, rf * features,
                         generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.strides)


class Dropout(nn.Module):
    """Dropout; identity in eval mode. Training-mode dropout (the Pallas
    dropout kernel's port) is not part of this slice."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "training-mode dropout is not ported yet (ROADMAP.md)")
        return x


class DownConv(nn.Module):
    """Stride-``factor`` convolution doubling channels, then norm and
    activation (children ``conv``, ``norm``, ``act``)."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = channels * factor
        self.conv = SpatialConv(channels, out, (factor,) * 3, (factor,) * 3,
                                generator=generator)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class UpConv(nn.Module):
    """Stride-``factor`` transpose convolution halving channels, then norm
    and activation (children ``deconv``, ``norm``, ``act``)."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out = channels // factor
        self.deconv = SpatialConvTranspose(channels, out, (factor,) * 3,
                                           (factor,) * 3, generator=generator)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x):
        return self.act(self.norm(self.deconv(x)))
