"""Weight gradient of stride-1 SAME 3D convolutions: the CUDA kernel's
wrapper, its plain PyTorch version, and the convolution whose backward pass
uses them.

Counterpart of ``vnet_tpu/ops/pallas/dw_conv.py`` (``dw_conv_pallas`` and
``conv_pallas_dw``):

    dW[co, ci, o] = sum_{b, p} x[b, p + o - lo, ci] * g[b, p, co]

summed in float32, ``lo = (k - 1) // 2`` per axis, x zero outside the
volume (``vnet_tpu/ops/conv_vjp.py:75-77``). Tensors keep the port's
logical ``(B, C, X, Y, Z)`` shape; the kernel (``csrc/dw_conv.cu``) reads
channels-last storage, the JAX layout. The JAX kernel's scope limits
(lane-aligned channels, at most 27 offsets) came from Mosaic and do not
apply: every stride-1 convolution with an odd kernel is in scope.

:func:`dw_conv` launches the kernel for CUDA tensors and takes
:func:`dw_conv_plain` only for CPU tensors; a CUDA tensor never falls back.
``dw_conv.launches`` counts kernel launches (one per weight gradient).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POSITIONS_PER_STEP = 64       # DW_PT in the .cu source
TARGET_BLOCKS = 132 * 32      # partial-sum blocks to aim for (132 SMs)
MAX_CHUNKS = 65535            # gridDim.y


def _check(x: torch.Tensor, g: torch.Tensor, kernel_size: Sequence[int]):
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"expected x (B, Ci, X, Y, Z) and g (B, Co, X, Y, "
                         f"Z), got {tuple(x.shape)} and {tuple(g.shape)}")
    if x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ "
                         "in batch or volume (stride 1, SAME)")
    if len(kernel_size) != 3 or any(k < 1 or k % 2 == 0
                                    for k in kernel_size):
        raise ValueError(f"odd kernel sizes only, got {kernel_size}")
    if x.dtype != g.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"x and g must share a float32, bfloat16 or float16 "
                        f"dtype, got {x.dtype} and {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")


def dw_conv_plain(x: torch.Tensor, g: torch.Tensor,
                  kernel_size: Sequence[int]) -> torch.Tensor:
    """A loop over kernel offsets of float32 contractions of shifted views
    of the zero-padded input; any device. Returns ``(Co, Ci, *k)`` f32."""
    _check(x, g, kernel_size)
    ks = tuple(int(k) for k in kernel_size)
    vol = x.shape[2:]
    pad = []
    for k in reversed(ks):
        pad += [(k - 1) // 2, k // 2]
    xp = F.pad(x.float(), pad)
    gf = g.float()
    out = torch.empty((g.shape[1], x.shape[1]) + ks, dtype=torch.float32,
                      device=x.device)
    for a, b, c in itertools.product(*(range(k) for k in ks)):
        window = xp[:, :, a:a + vol[0], b:b + vol[1], c:c + vol[2]]
        out[:, :, a, b, c] = torch.einsum("bixyz,boxyz->oi", window, gf)
    return out


def split(positions: int, offsets: int, channel_tiles: int) -> Tuple[int, int]:
    """``(chunks, chunk_len)``: the positions split into chunks so that
    about ``TARGET_BLOCKS`` blocks share the work, each chunk a whole number
    of staging steps."""
    steps = -(-positions // POSITIONS_PER_STEP)
    want = -(-TARGET_BLOCKS // (offsets * channel_tiles))
    chunks = max(1, min(steps, want, MAX_CHUNKS))
    chunk_len = -(-steps // chunks) * POSITIONS_PER_STEP
    return -(-positions // chunk_len), chunk_len


def _tile(c: int) -> int:
    """Channel tile per side (``tile`` in the .cu source)."""
    t = 4
    while t < c and t < 64:
        t *= 2
    return t


@functools.cache
def _kernel():
    fn = build.load("dw_conv").lib.vnet_dw_conv
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dw_conv(x: torch.Tensor, g: torch.Tensor,
            kernel_size: Sequence[int]) -> torch.Tensor:
    """Weight gradient ``(Co, Ci, *kernel_size)`` float32 of a stride-1 SAME
    convolution with input ``x`` ``(B, Ci, X, Y, Z)`` and output gradient
    ``g`` ``(B, Co, X, Y, Z)``. CUDA tensors launch ``csrc/dw_conv.cu`` (on
    channels-last copies where they are not channels-last already); CPU
    tensors take :func:`dw_conv_plain`."""
    _check(x, g, kernel_size)
    if x.device.type == "cpu":
        return dw_conv_plain(x, g, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ks = tuple(int(k) for k in kernel_size)
    cl = torch.channels_last_3d
    x = x.contiguous(memory_format=cl)
    g = g.contiguous(memory_format=cl)
    b, ci, *vol = x.shape
    co = g.shape[1]
    offsets = math.prod(ks)
    tiles = -(-ci // _tile(ci)) * -(-co // _tile(co))
    chunks, chunk_len = split(b * math.prod(vol), offsets, tiles)
    partial = torch.empty(chunks * offsets * ci * co, dtype=torch.float32,
                          device=x.device)
    out = torch.empty((co, ci) + ks, dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], b, *vol, ci, co, *ks,
                 chunks, chunk_len, stream)
    if err != 0:
        raise RuntimeError(f"dw_conv launch failed: CUDA error {err}")
    dw_conv.launches += 1
    return out


dw_conv.launches = 0


class _ConvDw(torch.autograd.Function):
    """``F.conv3d(x, w, padding=lo)``, stride 1; backward: dx from
    ``aten.convolution_backward`` (cuDNN on the card, as JAX takes dx from
    XLA), dW from :func:`dw_conv` cast to the weight's dtype (as
    ``dw_conv.py:323`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.padding = padding
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, None, 1, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1, 1), ctx.padding, (1, 1, 1), False,
                (0, 0, 0), 1, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            dw = dw_conv(x, g, tuple(w.shape[2:])).to(w.dtype)
        return dx, dw, None


def conv3d_dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution (odd kernel, no bias) whose weight
    gradient is :func:`dw_conv`."""
    if any(k % 2 == 0 for k in w.shape[2:]):
        raise ValueError(f"DwImpl 'pallas' takes odd kernels only, got "
                         f"{tuple(w.shape[2:])}")
    return _ConvDw.apply(x, w, tuple((k - 1) // 2 for k in w.shape[2:]))
