"""Layer primitives of the V-Net, 2D or 3D, direct convolutions.

Counterpart of ``vnet_tpu/models/layers.py``, rank-generic as it is: the
spatial rank is the kernel's length (convolutions) or ``x.ndim - 2``
(norms, activations). Tensors inside the network are logically ``(B, C,
*spatial)`` and physically channels-last (``torch.channels_last_3d``, or
``torch.channels_last`` in 2D), the layout the JAX package keeps as ``(B,
*spatial, C)``; the public entry points (``VNet.forward``) take and return
the JAX layout.

Sub-module names mirror the flax variable paths (``conv_1``, ``norm_1.bn``,
``act_1.prelu``) so that ``vnet_tpu_torch/convert.py`` maps weights
mechanically. Leaf parameters use PyTorch's names: ``weight``/``bias`` for
convolutions (``(O, I, *k)``; transpose convolutions ``(I, O, *k)``),
``weight``/``bias`` and the buffers ``running_mean``/``running_var`` for
batch norm, ``weight`` for PReLU's per-channel slope.

Numerics follow flax: BatchNorm momentum 0.99 and epsilon 1e-3, statistics
in float32 as ``E[x^2] - E[x]^2`` (clipped at 0), the running variance is
the biased one (``F.batch_norm`` and ``nn.BatchNorm3d`` would update it with
the unbiased one and drift from flax). Parameters stay float32 and are cast
to the compute dtype (``x.dtype``) at use, as the JAX modules do.

Training mode: batch norms update their running averages in place under
``no_grad``; ``Dropout`` runs ``ops/dropout.py`` (the CUDA kernel on the
card) and a 3D ``SpatialConv(dw_impl="pallas")`` takes its weight gradient
from ``ops/dw_conv.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout as dropout_op
from ..ops.dw_conv import conv3d_dw

NORM_KINDS = ("batch", "batch_stats", "group", "instance", "none")
ACTIVATIONS = ("relu", "prelu", "lrelu")

_EPS = 1e-3
_MOMENTUM = 0.99
DW_IMPLS = ("xla", "custom", "pallas")
_CONV = {2: F.conv2d, 3: F.conv3d}  # by spatial rank
_CONV_TRANSPOSE = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


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
    statistics of the batch itself are used and, in training mode, folded
    into the running averages (:meth:`update_running`).
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
            if self.training:
                self.update_running(mean, var)
        mul = torch.rsqrt(var + _EPS) * self.weight
        y = ((xf - _channel_view(mean, x.ndim)) * _channel_view(mul, x.ndim)
             + _channel_view(self.bias, x.ndim))
        return y.to(x.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = 0.99 * running + 0.01 * batch`` (flax's update, the
        biased batch variance)."""
        self.running_mean.copy_(_MOMENTUM * self.running_mean
                                + (1.0 - _MOMENTUM) * mean)
        self.running_var.copy_(_MOMENTUM * self.running_var
                               + (1.0 - _MOMENTUM) * var)


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
    variables sit in the ``bn`` child, as in ``Norm``; in training mode the
    scalar batch statistics, broadcast to C, update its running averages.
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
            if self.training:
                bn.update_running(mean, var)
        inv = torch.rsqrt(var + _EPS) * bn.weight
        shift = bn.bias - mean * inv
        return (x1 * _channel_view(inv.to(x1.dtype), x1.ndim)
                + _channel_view(shift.to(x1.dtype), x1.ndim))


class SpatialConv(nn.Module):
    """2D or 3D convolution (``len(kernel_size)``) with XLA ``"SAME"``
    padding, direct mode only.

    ``weight`` is ``(out, in, *kernel_size)``; Xavier-uniform init, zero
    bias; ``strides`` default to 1. ``dw_impl`` selects the weight gradient
    of stride-1 convolutions: ``"pallas"`` takes it from ``ops/dw_conv.py``
    (the CUDA kernel on the card) at rank 3, with the bias added outside
    that autograd Function as JAX adds it; ``"xla"`` and ``"custom"`` (the
    same math in the JAX package, ``ops/conv_vjp.py``) keep torch autograd
    of ``F.conv3d`` / ``F.conv2d``. The dW kernel is rank-3 only, as JAX's
    is: at rank 2 ``"pallas"`` keeps autograd of ``F.conv2d``, exactly as
    JAX's ``conv_pallas_dw`` takes its XLA weight gradient for an operand
    ``dw_conv_supported`` refuses (``vnet_tpu/ops/pallas/dw_conv.py``). That
    is a static routing by rank that matches the reference, not a fallback.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 dw_impl: str = "xla"):
        super().__init__()
        if dw_impl not in DW_IMPLS:
            raise ValueError(f"Unknown dw_impl {dw_impl!r}; expected one of "
                             f"{DW_IMPLS}")
        self.dw_impl = dw_impl
        self.kernel_size = tuple(int(k) for k in kernel_size)
        if len(self.kernel_size) not in _CONV:
            raise ValueError(f"SpatialConv is 2D or 3D, got kernel "
                             f"{self.kernel_size}")
        self.strides = (tuple(int(s) for s in strides) if strides is not None
                        else (1,) * len(self.kernel_size))
        self.weight = nn.Parameter(
            torch.empty((features, in_features) + self.kernel_size))
        rf = math.prod(self.kernel_size)
        _glorot_uniform_(self.weight, rf * in_features, rf * features,
                         generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if (self.dw_impl == "pallas" and len(self.kernel_size) == 3
                and self.strides == (1, 1, 1)):
            y = conv3d_dw(x, self.weight.to(x.dtype))
            return y + _channel_view(self.bias.to(x.dtype), y.ndim)
        pads = [same_pads(n, k, s) for n, k, s in
                zip(x.shape[2:], self.kernel_size, self.strides)]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        conv = _CONV[len(self.kernel_size)]
        return conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                    self.strides, padding)


class SpatialConvTranspose(nn.Module):
    """``lax.conv_transpose(..., "SAME")`` with kernel == stride (the
    V-Net's up-convolution), output ``stride * input``.

    ``weight`` is ``(in, out, *kernel_size)`` as ``F.conv_transpose3d``
    (or ``2d``) takes it. ``lax.conv_transpose`` does not flip the kernel
    and PyTorch's transpose convolution is the adjoint of a convolution, so
    the JAX kernel maps here spatially flipped (``convert.py``).
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.strides = tuple(int(s) for s in strides)
        if len(self.kernel_size) not in _CONV_TRANSPOSE:
            raise ValueError(f"SpatialConvTranspose is 2D or 3D, got kernel "
                             f"{self.kernel_size}")
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
        conv = _CONV_TRANSPOSE[len(self.kernel_size)]
        return conv(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                    self.strides)


class Dropout(nn.Module):
    """Dropout of flavour ``impl`` (``xla``, ``bits8``, ``pallas``; see
    ``ops/dropout.py``); identity in eval mode or at rate 0.

    The mask is keyed by ``(seed, index)``: ``seed`` is the training step's
    seed, set by the owning network before each forward (``VNet``), and
    ``index`` is fixed when the network is built, so two layers never share
    a mask and a backward pass regenerates its forward's mask.
    """

    def __init__(self, rate: float, impl: str = "xla", index: int = 0):
        super().__init__()
        if impl not in ("xla", "bits8", "pallas"):
            raise ValueError(f"Unknown dropout impl {impl!r}; expected "
                             "'xla', 'bits8' or 'pallas'")
        self.rate = float(rate)
        self.impl = impl
        self.index = int(index)
        self.seed: Optional[int] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.seed is None:
            raise ValueError("training-mode dropout needs a step seed "
                             "(VNet.forward(x, dropout_seed=...))")
        return dropout_op(x, self.seed, self.index, self.rate, self.impl)


class DownConv(nn.Module):
    """Stride-``factor`` convolution doubling channels, then norm and
    activation (children ``conv``, ``norm``, ``act``), over ``rank``
    spatial axes."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None, rank: int = 3):
        super().__init__()
        out = channels * factor
        self.conv = SpatialConv(channels, out, (factor,) * rank,
                                (factor,) * rank, generator=generator)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class UpConv(nn.Module):
    """Stride-``factor`` transpose convolution halving channels, then norm
    and activation (children ``deconv``, ``norm``, ``act``), over ``rank``
    spatial axes."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None, rank: int = 3):
        super().__init__()
        out = channels // factor
        self.deconv = SpatialConvTranspose(channels, out, (factor,) * rank,
                                           (factor,) * rank,
                                           generator=generator)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x):
        return self.act(self.norm(self.deconv(x)))
