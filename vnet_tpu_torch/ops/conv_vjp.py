"""Stride-1 convolution with an explicitly formulated weight gradient —
counterpart of ``vnet_tpu/ops/conv_vjp.py``.

:func:`conv_custom_dw` is the stride-1 convolution with explicit per-axis
``(lo, hi)`` pads. Its backward pass computes dx as autograd would (the
convolution's input gradient, cuDNN's on the card) and dW by itself,

    dW[co, ci, k...] = sum_{b, p} x[b, ci, p + k - lo] * dy[b, co, p]

as the weight output alone of ``aten.convolution_backward``: the same
function as autograd's, taken by its own route (``DwImpl: custom``). Rank 2
or 3; channels-last tensors stay channels-last.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .s2d import conv_padded, pad_for_conv


class _ConvCustomDw(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, pads):
        ctx.pads = pads
        ctx.save_for_backward(x, w)
        return conv_padded(x, w, pads)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rank = w.ndim - 2
        xp, padding = pad_for_conv(x, ctx.pads)
        ones, zeros = (1,) * rank, (0,) * rank
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, xp, w, None, ones, padding, ones, False, zeros, 1,
                (True, False, False))[0]
            if xp is not x:  # drop the gradient of the explicit padding
                dx = dx[(slice(None), slice(None)) + tuple(
                    slice(lo, lo + n) for (lo, _), n in
                    zip(ctx.pads, x.shape[2:]))]
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                g, xp, w, None, ones, padding, ones, False, zeros, 1,
                (False, True, False))[1].to(w.dtype)
        return dx, dw, None


def conv_custom_dw(x: torch.Tensor, w: torch.Tensor,
                   pads: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """Stride-1 convolution of ``x`` (``(B, Ci, *spatial)``) by ``w``
    (``(Co, Ci, *k)``) with per-axis ``(lo, hi)`` ``pads``, no bias; dW as
    the module docstring says."""
    return _ConvCustomDw.apply(x, w, tuple(tuple(p) for p in pads))


def same_pads(kernel_spatial: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Explicit SAME padding for stride 1: ``((k - 1) // 2, k // 2)`` per
    axis."""
    return tuple(((k - 1) // 2, k // 2) for k in kernel_spatial)
