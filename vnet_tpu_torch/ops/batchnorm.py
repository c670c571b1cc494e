"""Train-mode BatchNorm with its own backward, over a (possibly packed)
channels-last tensor.

Counterpart of ``vnet_tpu/ops/pallas/batchnorm.py``: ``(y, mean, var)`` of
exact train-mode BatchNorm (biased variance, float32 statistics, the
variance not clamped), as a ``torch.autograd.Function`` whose backward is
``_bn_bwd`` of the JAX package, including the direct gradients of ``mean``
and ``var``. A packed layout has ``groups * C`` channels, offset-major
(channel ``g * C + c`` is base channel ``c``), and its statistics reduce
over the groups too.

``STATS_IMPL`` selects the statistics reductions, as the JAX module switch:
``"pallas"`` takes ``ops/fused.py``'s ``bn_stats`` and ``bn_grad_stats``
(the CUDA kernels for CUDA tensors), ``"xla"`` plain torch reductions, and
``"auto"`` the kernels for CUDA tensors. No model calls this module, as in
the JAX package: the port's ``models/layers.py::BatchNorm`` is autograd of
plain torch ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fused import bn_grad_stats, bn_stats

STATS_IMPL = "xla"
STATS_IMPLS = ("xla", "pallas", "auto")


def stats_impl(x: torch.Tensor) -> str:
    """``"pallas"`` or ``"xla"`` for ``x`` under :data:`STATS_IMPL`."""
    if STATS_IMPL not in STATS_IMPLS:
        raise ValueError(f"Unknown STATS_IMPL {STATS_IMPL!r}; expected one "
                         f"of {STATS_IMPLS}")
    if STATS_IMPL == "auto":
        return "pallas" if x.is_cuda else "xla"
    return STATS_IMPL


def _fold(v: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-packed-channel ``(groups * C,)`` -> per-base-channel ``(C,)``."""
    return v.reshape(groups, -1).sum(0) if groups > 1 else v


def _moments(x: torch.Tensor, groups: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-base-channel ``(mean, E[x^2])`` in float32 over every leading dim
    and the ``groups`` offset blocks."""
    cp = x.shape[-1]
    n = x.numel() // (cp // groups)
    if stats_impl(x) == "pallas":
        s, sq = bn_stats(x)
    else:
        xf = x.reshape(-1, cp).float()
        s, sq = xf.sum(0), (xf * xf).sum(0)
    return _fold(s, groups) / n, _fold(sq, groups) / n


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        mean, meansq = _moments(x, groups)
        var = meansq - mean.square()
        inv = torch.rsqrt(var + eps)
        a = inv * scale.float()
        b = bias.float() - mean * a
        y = x * a.repeat(groups).to(x.dtype) + b.repeat(groups).to(x.dtype)
        ctx.groups = groups
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv = ctx.saved_tensors
        groups = ctx.groups
        cp = x.shape[-1]
        n = x.numel() // (cp // groups)
        meant, invt = mean.repeat(groups), inv.repeat(groups)
        if dy is None:
            dy = torch.zeros_like(x)
        if stats_impl(x) == "pallas":
            sum_dy_p, sum_dy_xhat_p = bn_grad_stats(dy, x, meant, invt)
        else:
            dyf = dy.reshape(-1, cp).float()
            xhat = (x.reshape(-1, cp).float() - meant) * invt
            sum_dy_p, sum_dy_xhat_p = dyf.sum(0), (dyf * xhat).sum(0)
        sum_dy = _fold(sum_dy_p, groups)
        sum_dy_xhat = _fold(sum_dy_xhat_p, groups)

        # dx of y = (x - mean(x)) * rsqrt(var(x) + eps) * scale + bias
        # (biased variance), plus the direct gradients of mean and var:
        #   dx = inv*scale * (dy - sum_dy/n - xhat * sum_dy_xhat/n)
        #      + dmean/n + dvar * 2*(x - mean)/n
        xf = x.float()
        xhat = (xf - meant) * invt
        c1 = (inv * scale.float()).repeat(groups)
        dx = c1 * (dy.float() - sum_dy.repeat(groups) / n
                   - xhat * (sum_dy_xhat.repeat(groups) / n))
        if dmean is not None:
            dx = dx + dmean.repeat(groups) / n
        if dvar is not None:
            dx = dx + dvar.repeat(groups) * 2.0 * (xf - meant) / n
        return (dx.to(x.dtype), sum_dy_xhat.to(scale.dtype),
                sum_dy.to(scale.dtype), None, None)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     _unused: float = 0.0, groups: int = 1,
                     eps: float = 1e-3
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of ``x`` ``(..., groups * C)``, any float dtype,
    with ``scale`` and ``bias`` ``(C,)``. Returns ``(y, mean, var)``: ``y``
    in ``x``'s dtype, ``mean`` and ``var`` float32 ``(C,)`` (for the
    caller's running-average update). ``_unused`` keeps the JAX signature.
    """
    del _unused
    cp = x.shape[-1]
    if groups < 1 or cp % groups or cp // groups != scale.shape[0]:
        raise ValueError(f"x has {cp} channels; expected groups={groups} x "
                         f"C={scale.shape[0]}")
    return _BatchNormTrain.apply(x, scale, bias, int(groups), float(eps))
