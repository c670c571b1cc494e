"""Layer primitives of the model zoo, 2D or 3D, direct or packed.

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

Batch norms run with the activation that follows them as one autograd
Function (``ops/bn_act.py``: hand-written CUDA kernels for CUDA tensors,
their plain versions for any other; under ``torch.export`` the plain
operators of :meth:`BatchNorm.eager`); callers hand the activation to the
norm (``norm(x, groups, act=act)``). Training mode: batch norms update
their running averages in place; ``Dropout`` runs ``ops/dropout.py`` (the
CUDA kernel on the card) and a 3D ``SpatialConv(dw_impl="pallas")`` takes
its weight gradient from ``ops/dw_conv.py``.

Data parallelism (``parallel/mesh.py``): inside ``data_parallel(mesh)``,
which the training and evaluation steps set, every batch norm that
computes batch statistics averages ``(E[x], E[x^2])`` over the ranks,
differentiably (one all-reduce forward, one backward), as flax's
``BatchNorm`` reduces over the global batch under JAX's data-parallel jit;
shards are equal, so the mean of the ranks' moments is the global one, and
the running averages are the same on every rank. ``Dropout`` counts its
mask from the rank's first element of the global batch, so the ranks draw
the global batch's mask. Outside that context (the sliding window, as
JAX's ``shard_map``) statistics are the rank's own.

Spatial partitioning (``parallel/spatial.py``): inside a partition, which
the trainer enters with ``Mesh.SpaceParallel > 1`` and the
``spatial_sharded_*`` functions enter themselves, a stencil convolution
exchanges halos with its ring neighbours along the sharded axis and
convolves VALID there, SAME elsewhere (direct, per-site ``s2d`` and packed
alike; stride-2 and 1^r convolutions stay local); halo'd convolutions take
autograd's weight gradient, as JAX's ``dw_conv_supported`` refuses an
operand whose extents differ from the gradient's. Batch statistics average
over the mesh (or over the partition without one), group and instance
norm over the partition, and dropout draws the rank's slab of the
unsharded tensor's mask through the counter's row map.

Recomputation (``Networks.Remat``; flax's ``nn.remat``): :func:`recomputed`
runs a block through ``torch.utils.checkpoint`` (non-reentrant) in train
mode with gradients on, so that its activations are made again in the
backward pass instead of kept. The recompute sees what the forward saw,
captured when the block ran forward: every dropout layer's seed (its mask
map follows from the mesh and the partition), the active mesh, the
partition and the modules' train modes; batch norms do not fold the
recompute's statistics into their running averages (:func:`recomputing`),
so they move once a step, as in flax. Under a mesh the recompute reduces
its batch moments over the ranks again, as JAX's recompute under ``pjit``
does, and exchanges its halos again, in the forward's order on every rank.
Eval mode, ``inference_mode`` and ``no_grad`` run the block as it is.

Packed domain (``ops/s2d.py``): a tensor of ``groups * C`` channels,
offset-major. Whether a layer runs packed depends on the input's extents,
which JAX decides when it traces; here the owning network decides it at
each forward and passes it as forward arguments (``groups`` of ``Norm``
and ``Activation``; ``packed``, ``packed_factors`` (``None``: every axis
packed), ``packed_input_splits``, ``packed_down``, ``packed_down_keep`` of
``SpatialConv``; ``packed_output`` of the up and down convolutions). The
parameters do not depend on it: the same weights serve both modes, as
JAX's checkpoints interchange between them.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.bn_act import (CLIPPED, MOMENTS, RUNNING, activation_plain,
                          batch_norm_act, moment_sums_plain, normalize_plain)
from ..ops.bn_act import update_running as _update_running
from ..ops.conv_vjp import conv_custom_dw
from ..ops.conv_vjp import same_pads as stride1_pads
from ..ops.dropout import dropout as dropout_op
from ..ops.dw_conv import conv3d_dw
from ..ops.s2d import (conv_padded, norm_factors, packed_conv,
                       packed_down_conv, prod_factors, s2d_conv,
                       s2d_down_conv, s2d_up_conv)
from ..parallel.mesh import active_mesh, group_all_reduce_mean, mesh_scope
from ..parallel.spatial import (current_partition, halo_exchange_asym,
                                partition_scope)
from ..profiler import span

NORM_KINDS = ("batch", "batch_stats", "group", "instance", "none")
ACTIVATIONS = ("relu", "prelu", "lrelu")

_EPS = 1e-3
DW_IMPLS = ("xla", "custom", "pallas")
CONV_IMPLS = ("direct", "s2d", "auto")
_CONV = {2: F.conv2d, 3: F.conv3d}  # by spatial rank
_CONV_TRANSPOSE = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar(
    "vnet_recomputing", default=False)


def recomputing() -> bool:
    """Whether the code runs in a block's recompute (:func:`recomputed`)."""
    return _RECOMPUTING.get()


def recomputed(module: nn.Module, *args, enabled: bool = True, **kwargs):
    """``module(*args, **kwargs)``, its activations recomputed in the
    backward pass instead of kept (flax's ``nn.remat``), where that does
    something: ``enabled`` (``Networks.Remat``), in train mode with
    gradients on; otherwise the plain call. Only the block's inputs are
    saved; the recompute runs under what the forward saw (:class:`_Seen`).
    Nothing in a block draws from torch's generators (dropout is keyed by
    counters), so their states are not stashed."""
    if not (enabled and module.training and torch.is_grad_enabled()):
        return module(*args, **kwargs)
    return checkpoint(module, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=_Seen(module).contexts, **kwargs)


class _Seen:
    """What a block saw when it ran forward, for its recompute, which may
    run late (after a later forward set other seeds) and out of context
    (outside ``data_parallel``, or on autograd's device thread, which
    inherits no context variables): each dropout layer's seed, each
    module's train mode, the active mesh and the partition. A context
    manager around the recompute, entered once a backward over the graph
    (again for a second backward over a retained graph)."""

    def __init__(self, module: nn.Module):
        self.modes = [(m, m.training) for m in module.modules()]
        self.seeds = [(m, m.seed) for m, _ in self.modes
                      if isinstance(m, Dropout)]
        self.mesh = active_mesh()
        self.partition = current_partition()
        self.entries = []  # per entry: (modes, seeds, token, scopes) to undo

    def contexts(self):
        """``torch.utils.checkpoint``'s ``context_fn``: nothing around the
        forward, this object around the recompute."""
        return contextlib.nullcontext(), self

    def __enter__(self):
        modes = [(m, m.training) for m, _ in self.modes]
        seeds = [(m, m.seed) for m, _ in self.seeds]
        for m, mode in self.modes:
            m.training = mode
        for m, seed in self.seeds:
            m.seed = seed
        token = _RECOMPUTING.set(True)
        scopes = contextlib.ExitStack()
        self.entries.append((modes, seeds, token, scopes))
        try:
            scopes.enter_context(span("vnet.remat.recompute"))
            scopes.enter_context(mesh_scope(self.mesh))
            scopes.enter_context(partition_scope(self.partition))
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        modes, seeds, token, scopes = self.entries.pop()
        try:
            scopes.close()
        finally:
            _RECOMPUTING.reset(token)
            for m, mode in modes:
                m.training = mode
            for m, seed in seeds:
                m.seed = seed
        return False


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over ``(B, C, *spatial)``."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _plus_bias(y: torch.Tensor, b: Optional[torch.Tensor],
               groups: int = 1) -> torch.Tensor:
    """``y`` plus the per-channel bias ``b`` tiled over ``groups`` offset
    groups; ``y`` itself for a convolution without a bias."""
    if b is None:
        return y
    return y + _channel_view(b.repeat(groups) if groups > 1 else b, y.ndim)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: Optional[torch.Generator]) -> None:
    """flax ``glorot_uniform`` (Xavier uniform, the reference's conv init)."""
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-lim, lim, generator=generator)


def _partition_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the active spatial partition (equal slabs)."""
    part = current_partition()
    if part is None:
        return t
    return group_all_reduce_mean(t, part.group, part.size)


def moments_group():
    """``(process group, size)`` over which batch statistics average: every
    rank of the active mesh (``None``: the default group), else the active
    spatial partition; ``None`` where they are the rank's own."""
    mesh = active_mesh()
    if mesh is not None:
        return (None, mesh.world_size) if mesh.parallel else None
    part = current_partition()
    if part is None or part.size <= 1:
        return None
    return part.group, part.size


def batch_moments(xf: torch.Tensor, axes=None):
    """``(E[x], E[x^2])`` of float32 ``xf`` over ``axes`` (every axis for
    ``None``), averaged over :func:`moments_group` (equal shards: the
    global moments), differentiably."""
    if axes is None:
        mean, sq = xf.mean(), xf.square().mean()
    else:
        mean, sq = xf.mean(axes), xf.square().mean(axes)
    return _mean_over_group(torch.stack([mean, sq])).unbind(0)


def _mean_over_group(t: torch.Tensor) -> torch.Tensor:
    group = moments_group()
    return t if group is None else group_all_reduce_mean(t, *group)


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """(lo, hi) padding of XLA's ``"SAME"`` for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class PReLU(nn.Module):
    """Per-channel parametric ReLU, slope initialised to 0.1; computed as
    ``max(x, 0) + alpha * min(x, 0)`` in the compute dtype, as JAX does.
    ``groups > 1``: a packed input, the slope tiled over the offset
    groups."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.1))

    def forward(self, x, groups: int = 1):
        return activation_plain(x, "prelu", self.weight, groups)


class Activation(nn.Module):
    """String-dispatched activation; PReLU lives in the ``prelu`` child."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ACTIVATIONS:
            raise ValueError(f"Unknown activation: {kind!r}")
        self.kind = kind
        if kind == "prelu":
            self.prelu = PReLU(features)

    @property
    def alpha(self) -> Optional[torch.Tensor]:
        """PReLU's slope, ``None`` for the other kinds."""
        return self.prelu.weight if self.kind == "prelu" else None

    def forward(self, x, groups: int = 1):
        return activation_plain(x, self.kind, self.alpha, groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis.

    ``use_running_average`` selects the stored statistics; otherwise the
    statistics of the batch itself are used and, in training mode, folded
    into the running averages (:meth:`update_running`), but not in a
    block's recompute (:func:`recomputed`).

    ``groups > 1``: JAX's ``PackedBatchNorm`` — the input holds ``groups *
    C`` packed channels and the statistics reduce over batch, packed
    spatial and offset groups, which equals the unpacked per-channel
    statistics; the variance is ``E[x^2] - E[x]^2`` unclipped, as there.
    Parameters and buffers stay ``(C,)``.

    ``act``: the :class:`Activation` that follows, computed in the same
    passes. The forward is ``ops/bn_act.py``'s autograd Function (the CUDA
    kernels for a CUDA tensor, their plain versions for any other); under
    ``torch.export`` it is :meth:`eager`, the chain of plain operators that
    autograd differentiates, which the Function equals given the same
    statistics.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, use_running_average: bool, groups: int = 1,
                act: Optional["Activation"] = None):
        if torch.compiler.is_compiling():  # the kernels take no fake tensors
            y = self.eager(x, use_running_average, groups)
            return y if act is None else act(y, groups)
        batch = not use_running_average
        return batch_norm_act(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            act="none" if act is None else act.kind,
            alpha=None if act is None else act.alpha, groups=groups,
            batch=batch, update=batch and self.training and not recomputing(),
            group=moments_group() if batch else None)

    def eager(self, x, use_running_average: bool, groups: int = 1):
        """The norm as plain operators, differentiated by autograd."""
        if use_running_average:
            first, second = self.running_mean, self.running_var
            kind = RUNNING
        else:
            first, second = _mean_over_group(moment_sums_plain(x)).unbind(0)
            kind = CLIPPED if groups == 1 else MOMENTS
        y, mean, var = normalize_plain(x, first, second, kind, self.weight,
                                       self.bias, groups)
        if kind != RUNNING and self.training and not recomputing():
            self.update_running(mean, var)
        return y

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = 0.99 * running + 0.01 * batch`` (flax's update, the
        biased batch variance)."""
        _update_running(self.running_mean, self.running_var, mean, var)


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
        mean, sq = _partition_mean(torch.stack([
            xg.mean(axes, keepdim=True),
            xg.square().mean(axes, keepdim=True)])).unbind(0)
        var = torch.clamp_min(sq - mean.square(), 0.0)
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
    ``groups > 1``: a packed input, batch kinds only. A ``(B, F)`` input
    (the Dense network) has no spatial axes: batch kinds reduce over the
    batch, ``instance`` over nothing, as ``jnp.mean(axis=())`` does.
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

    def forward(self, x, groups: int = 1,
                act: Optional["Activation"] = None):
        """The norm of ``x``, then ``act`` (an :class:`Activation`) if
        given; a batch kind computes both in one pass of ``ops/bn_act.py``."""
        if self.kind in ("batch", "batch_stats"):
            return self.bn(x, self.kind == "batch" and not self.training,
                           groups, act)
        y = self._other(x, groups)
        return y if act is None else act(y, groups)

    def _other(self, x, groups: int):
        if self.kind == "none":
            return x
        if groups > 1:
            raise ValueError(f"packed norm only supports batch kinds, got "
                             f"{self.kind}")
        if self.kind == "group":
            return self.gn(x)
        xf = x.float()
        axes = tuple(range(2, x.ndim))
        if axes:
            mean, sq = _partition_mean(torch.stack([
                xf.mean(axes, keepdim=True),
                xf.square().mean(axes, keepdim=True)])).unbind(0)
            var = sq - mean.square()
        else:  # no spatial axes: each value is its own mean
            mean, var = xf, torch.zeros_like(xf)
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
            mu, sq = batch_moments(x1.float())
            var_s = sq - mu.square()
            mean, var = mu.expand(c), var_s.expand(c)
            if self.training and not recomputing():
                bn.update_running(mean, var)
        inv = torch.rsqrt(var + _EPS) * bn.weight
        shift = bn.bias - mean * inv
        return (x1 * _channel_view(inv.to(x1.dtype), x1.ndim)
                + _channel_view(shift.to(x1.dtype), x1.ndim))


class SpatialConv(nn.Module):
    """2D or 3D convolution (``len(kernel_size)``) with XLA ``"SAME"``
    padding, by the implementation of JAX's ``SpatialConv``.

    ``weight`` is ``(out, in, *kernel_size)``; Xavier-uniform init, zero
    bias (none with ``bias=False``, as MONAI's UNETR blocks build their
    convolutions); ``strides`` default to 1.

    ``impl`` (fixed when built): ``"direct"`` — the convolution itself;
    ``"s2d"`` — the space-to-depth rewrite (``ops/s2d.py``), raising where
    it does not apply; ``"auto"`` — the rewrite where it applies (``can_s2d``:
    a cubic odd kernel of at least 5, stride 1, even extents, ``2^r *
    max(in, out) <= 1024``), and for a stride-2 2^r convolution on even
    extents (``can_down``) the matrix product of ``s2d_down_conv`` in both
    modes, as ``vnet_tpu/models/layers.py:392-420`` decides.

    Forward arguments (decided by the owning network per input shape):
    ``packed`` — input and output in the packed domain of
    ``packed_factors`` (``None``: every axis), the weight packed at apply
    time, a 1^r kernel a product shared by the offset groups;
    ``packed_input_splits`` — the packed input is a flat concat of
    separately packed tensors; ``packed_down`` — a stride-2 2^r convolution
    of a packed input, one matrix product, its output unpacked or, with
    ``packed_down_keep``, in the next level's packed layout.

    ``dw_impl`` selects the weight gradient of stride-1 convolutions (direct
    and packed): ``"pallas"`` takes it from ``ops/dw_conv.py`` (the CUDA
    kernel on the card) at rank 3, with the bias added outside that
    autograd Function as JAX adds it; ``"custom"`` from
    ``ops/conv_vjp.py::conv_custom_dw``; ``"xla"`` from torch autograd. The
    dW kernel is rank-3 only, as JAX's is: at rank 2 ``"pallas"`` keeps
    autograd's, exactly as JAX's ``conv_pallas_dw`` takes its XLA weight
    gradient for an operand ``dw_conv_supported`` refuses
    (``vnet_tpu/ops/pallas/dw_conv.py``). That is a static routing by rank
    that matches the reference, not a fallback. The per-site ``s2d``
    rewrite keeps autograd's weight gradient, as JAX's ``s2d_conv`` does.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 dw_impl: str = "xla", impl: str = "direct",
                 bias: bool = True):
        super().__init__()
        if dw_impl not in DW_IMPLS:
            raise ValueError(f"Unknown dw_impl {dw_impl!r}; expected one of "
                             f"{DW_IMPLS}")
        if impl not in CONV_IMPLS:
            raise ValueError(f"Unknown conv impl {impl!r}; expected one of "
                             f"{CONV_IMPLS}")
        self.dw_impl = dw_impl
        self.impl = impl
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
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x, packed: bool = False, packed_factors=None,
                packed_input_splits=None, packed_down: bool = False,
                packed_down_keep: bool = False):
        rank = len(self.kernel_size)
        k = self.kernel_size
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if packed_down:
            if k != (2,) * rank or self.strides != (2,) * rank:
                raise ValueError(f"packed_down needs a stride-2 2^r conv, "
                                 f"got kernel {k}, strides {self.strides}")
            y = packed_down_conv(x, w, keep_packed=packed_down_keep,
                                 factors=packed_factors)
            return _plus_bias(y, b, 2 ** rank if packed_down_keep else 1)
        if packed:
            factors = norm_factors(packed_factors, rank)
            groups = prod_factors(factors)
            if k == (1,) * rank:
                # the packed pointwise convolution: one weight shared by
                # every offset group, a grouped matrix product
                cout, cin = w.shape[:2]
                xs = x.movedim(1, -1)
                xg = xs.reshape(xs.shape[:-1] + (groups, cin))
                y = torch.matmul(xg, w.reshape(cout, cin).t())
                y = y.reshape(xs.shape[:-1] + (groups * cout,)).movedim(-1, 1)
            else:
                y = packed_conv(x, w, input_splits=packed_input_splits,
                                factors=factors, dw_impl=self.dw_impl,
                                halo=current_partition())
            return _plus_bias(y, b, groups)

        stride1 = self.strides == (1,) * rank
        even = all(n % 2 == 0 for n in x.shape[2:])
        uniform = len(set(k)) == 1
        can_s2d = (uniform and k[0] % 2 == 1 and k[0] >= 5 and stride1
                   and even and 2 ** rank * max(w.shape[:2]) <= 1024)
        can_down = (uniform and k[0] == 2 and self.strides == (2,) * rank
                    and even)
        use_s2d = self.impl == "s2d" or (self.impl == "auto" and can_s2d)
        if use_s2d and not can_s2d:
            raise ValueError(f"s2d conv not applicable: kernel={k}, "
                             f"strides={self.strides}, "
                             f"spatial={tuple(x.shape[2:])}")
        part = current_partition()
        if part is not None and not stride1:
            # a strided convolution of an even slab touches each voxel
            # once along the sharded axis: local
            sp = part.axis
            if not (k[sp] <= self.strides[sp]
                    and x.shape[2 + sp] % self.strides[sp] == 0):
                raise NotImplementedError(
                    f"spatial partition: strided conv k={k} "
                    f"s={self.strides} needs halos")
        if self.impl != "direct" and can_down:
            y = s2d_down_conv(x, w)
        elif use_s2d:
            y = s2d_conv(x, w, halo=part)
        elif part is not None and stride1 and any(kk > 1 for kk in k):
            return self._halo_conv(x, w, b, part)
        elif self.dw_impl == "pallas" and rank == 3 and stride1:
            y = conv3d_dw(x, w)
        elif self.dw_impl == "custom" and stride1:
            y = conv_custom_dw(x, w, stride1_pads(k))
        else:
            pads = [same_pads(n, kk, s) for n, kk, s in
                    zip(x.shape[2:], k, self.strides)]
            if all(lo == hi for lo, hi in pads):
                padding = tuple(lo for lo, _ in pads)
            else:
                x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
                padding = 0
            return _CONV[rank](x, w, b, self.strides, padding)
        return _plus_bias(y, b)

    def _halo_conv(self, x, w, b, part):
        """The stride-1 convolution of a slab of a spatially partitioned
        tensor (``vnet_tpu/models/layers.py:428-447``): halos along the
        sharded axis and VALID there, SAME elsewhere."""
        k, sp = self.kernel_size, part.axis
        xh = halo_exchange_asym(x, (k[sp] - 1) // 2, k[sp] // 2, part, 2 + sp)
        pads = [((kk - 1) // 2, kk // 2) for kk in k]
        pads[sp] = (0, 0)
        return _plus_bias(conv_padded(xh, w, pads), b)


class SpatialConvTranspose(nn.Module):
    """``lax.conv_transpose(..., "SAME")`` with kernel == stride (the
    V-Net's up-convolution), output ``stride * input``.

    ``weight`` is ``(in, out, *kernel_size)`` as ``F.conv_transpose3d``
    (or ``2d``) takes it; ``bias=False`` builds it without a bias. ``lax.conv_transpose`` does not flip the kernel
    and PyTorch's transpose convolution is the adjoint of a convolution, so
    the JAX kernel maps here spatially flipped (``convert.py``).

    ``impl`` ``"s2d"`` or ``"auto"``: the stride-2 2^r case is a matrix
    product and a depth-to-space (``ops/s2d.py::s2d_up_conv``).
    ``forward(x, packed_output=True, packed_factors=f)`` returns that
    product in the packed domain of ``f`` (``None``: every axis) instead.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 impl: str = "direct", bias: bool = True):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f"Unknown conv impl {impl!r}; expected one of "
                             f"{CONV_IMPLS}")
        self.impl = impl
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
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x, packed_output: bool = False, packed_factors=None):
        rank = len(self.kernel_size)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        can_up = self.kernel_size == (2,) * rank
        if packed_output:
            if not can_up:
                raise ValueError("packed_output needs a stride-2 2^r kernel")
            y = s2d_up_conv(x, w, keep_packed=True,
                            out_factors=packed_factors)
            groups = prod_factors(norm_factors(packed_factors, rank))
            return _plus_bias(y, b, groups)
        if self.impl != "direct" and can_up:
            return _plus_bias(s2d_up_conv(x, w), b)
        return _CONV_TRANSPOSE[rank](x, w, b, self.strides)


class Dropout(nn.Module):
    """Dropout of flavour ``impl`` (``xla``, ``bits8``, ``pallas``; see
    ``ops/dropout.py``); identity in eval mode or at rate 0.

    The mask is keyed by ``(seed, index)``: ``seed`` is the training step's
    seed, set by the owning network before each forward (``VNet``), and
    ``index`` is fixed when the network is built, so two layers never share
    a mask and a backward pass regenerates its forward's mask. Inside a
    mesh or a spatial partition the rank draws its part of the unsharded
    tensor's mask (:func:`mask_map`).
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
        return dropout_op(x, self.seed, self.index, self.rate, self.impl,
                          *mask_map(x))


def mask_map(x: torch.Tensor):
    """``(base, row_len, row_stride)`` of the counter (``ops/dropout.py``)
    that gives this rank its part of the mask of the unsharded tensor: the
    data row's block of the global batch (``base`` = the elements of the
    rows before it) and, in a spatial partition of ``S`` slabs along
    spatial axis ``a``, the slab: in the ``(B, *spatial, C)`` counter order
    the rank holds runs of ``L`` = the elements from axis ``a`` on, ``G =
    L * S`` apart, its first at ``s * L``."""
    mesh, part = active_mesh(), current_partition()
    n = x.numel()
    shards = 1 if part is None else part.size
    rows = 0 if mesh is None else mesh.data_index
    base = rows * n * shards
    if part is None or part.size == 1:
        return base, 0, 0
    row_len = math.prod(x.shape[2 + part.axis:]) * x.shape[1]
    return base + part.index * row_len, row_len, row_len * part.size


class DownConv(nn.Module):
    """Stride-``factor`` convolution doubling channels, then norm and
    activation (children ``conv``, ``norm``, ``act``), over ``rank``
    spatial axes; ``impl`` is the convolution's (``SpatialConv``).

    ``forward(x, packed_input=True, packed_factors=f)``: ``x`` is packed
    (``f``: its per-axis packing, ``None`` every axis), the convolution one
    matrix product; ``packed_output`` (full packing only) emits the next
    level's packed layout, normalised and activated there."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None, rank: int = 3,
                 impl: str = "direct"):
        super().__init__()
        out = channels * factor
        self.factor = factor
        self.conv = SpatialConv(channels, out, (factor,) * rank,
                                (factor,) * rank, generator=generator,
                                impl=impl)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x, packed_input: bool = False, packed_factors=None,
                packed_output: bool = False):
        if packed_output and not packed_input:
            raise ValueError("packed_output needs packed_input")
        if not packed_input:
            return self.norm(self.conv(x), act=self.act)
        if self.factor != 2:
            raise ValueError("a packed input needs factor 2")
        x = self.conv(x, packed_down=True, packed_down_keep=packed_output,
                      packed_factors=packed_factors)
        groups = 2 ** (x.ndim - 2) if packed_output else 1
        return self.norm(x, groups, act=self.act)


class UpConv(nn.Module):
    """Stride-``factor`` transpose convolution halving channels, then norm
    and activation (children ``deconv``, ``norm``, ``act``), over ``rank``
    spatial axes; ``impl`` is the transpose convolution's.

    ``forward(x, packed_output=True, packed_factors=f)`` stays in the packed
    domain of the output grid (``f``: which axes stay packed, ``None``
    every axis), norm and activation offset-aware; the decoder block that
    consumes it skips its own packing."""

    def __init__(self, channels: int, factor: int = 2, norm: str = "batch",
                 activation: str = "prelu",
                 generator: Optional[torch.Generator] = None, rank: int = 3,
                 impl: str = "direct"):
        super().__init__()
        out = channels // factor
        self.factor = factor
        self.deconv = SpatialConvTranspose(channels, out, (factor,) * rank,
                                           (factor,) * rank,
                                           generator=generator, impl=impl)
        self.norm = Norm(norm, out)
        self.act = Activation(activation, out)

    def forward(self, x, packed_output: bool = False, packed_factors=None):
        if not packed_output:
            return self.norm(self.deconv(x), act=self.act)
        if self.factor != 2:
            raise ValueError("a packed output needs factor 2")
        rank = x.ndim - 2
        groups = prod_factors(norm_factors(packed_factors, rank))
        x = self.deconv(x, packed_output=True, packed_factors=packed_factors)
        return self.norm(x, groups, act=self.act)
