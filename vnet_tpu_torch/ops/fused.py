"""BatchNorm statistics and the fused bias + PReLU + residual tail: the CUDA
kernels' wrappers and their plain PyTorch versions.

Counterparts of ``vnet_tpu/ops/pallas/fused.py``'s ``bn_stats``,
``bn_grad_stats`` and ``fused_bias_prelu_residual``, with the same
signatures and the same channels-last ``(..., C)`` layout; the kernels see a
row-major ``(rows, C)`` view. ``bn_stats`` and ``bn_grad_stats`` share
``csrc/bn_stats.cu`` (per-block float32 partials added in a fixed order, so
the sums are the same from run to run); the tail is
``csrc/bias_prelu_residual.cu`` (rounded to the dtype after every operation,
bitwise equal to its plain version). The Mosaic arguments ``tile_rows`` and
``interpret`` are tiling hints of the TPU kernels and are ignored.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors; a CUDA tensor never falls back. Each wrapper's
``.launches`` counts its launches: one per call of the kernel's entry point,
which for ``bn_stats`` and ``bn_grad_stats`` is a pair of kernels (the
per-block partials, then their reduction), as for ``dw_conv``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TARGET_BLOCKS = 132 * 8  # partial-sum blocks to aim for (132 SMs)
THREADS = 256            # BN_THREADS in bn_stats.cu: channel groups per slab


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """Row-major ``(rows, C)`` view (a copy where ``x`` is not contiguous)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name} needs a trailing channel axis, got "
                         f"{tuple(x.shape)}")
    return x.reshape(-1, x.shape[-1]).contiguous()


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (the kernels' vector
    loads)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def split_rows(rows: int, c: int, vec: int, size: int) -> Tuple[int, int]:
    """``(chunks, chunk_rows)``: rows split so that about ``TARGET_BLOCKS``
    blocks share the work (``bn_stats.cu``'s grid is chunks x slabs)."""
    groups = c // (16 // size) if vec else c
    slabs = -(-groups // THREADS)
    chunks = max(1, min(rows, -(-TARGET_BLOCKS // slabs)))
    chunk_rows = -(-rows // chunks)
    return -(-rows // chunk_rows), chunk_rows


def bn_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(sum, sum of squares)``; any device."""
    xf = _rows(x, "bn_stats").float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_grad_stats_plain(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                        invstd: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(sum dy, sum dy * xhat)``,
    ``xhat = (x - mean) * invstd``; any device."""
    dyf = _rows(dy, "bn_grad_stats").float()
    xhat = (_rows(x, "bn_grad_stats").float() - mean.float()) * invstd.float()
    return dyf.sum(0), (dyf * xhat).sum(0)


@functools.cache
def _lib():
    lib = build.load("bn_stats").lib
    tail = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.vnet_bn_stats.argtypes = [ctypes.c_void_p] * 3 + tail
    lib.vnet_bn_grad_stats.argtypes = [ctypes.c_void_p] * 6 + tail
    lib.vnet_bn_stats.restype = lib.vnet_bn_grad_stats.restype = ctypes.c_int
    return lib


def _reduce(fn, wrapper, inputs, stats, name):
    """Launch one of ``bn_stats.cu``'s entry points over ``inputs``
    (``(rows, C)`` tensors of one dtype) and ``stats`` (float32 vectors);
    ``(2, C)`` float32."""
    x2 = inputs[-1]
    rows, c = x2.shape
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    if rows == 0:
        return out.zero_()
    vec = int((c * x2.element_size()) % 16 == 0 and _aligned(*inputs))
    chunks, chunk_rows = split_rows(rows, c, vec, x2.element_size())
    partial = torch.empty(chunks * 2 * c, dtype=torch.float32,
                          device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs + stats), partial.data_ptr(),
                 out.data_ptr(), _DTYPES[x2.dtype], rows, c, vec, chunks,
                 chunk_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def bn_sums(x: torch.Tensor) -> torch.Tensor:
    """:func:`bn_stats` as one ``(2, C)`` float32 tensor (no copy on the
    card); counted in ``bn_stats.launches``."""
    x2 = _rows(x, "bn_stats")
    if _device(x) == "cpu":
        return torch.stack(bn_stats_plain(x2))
    return _reduce(_lib().vnet_bn_stats, bn_stats, (x2,), (), "bn_stats")


def bn_stats(x: torch.Tensor, *, tile_rows: int = 0,
             interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(sum, sum_of_squares)`` of ``x`` ``(..., C)`` over all
    leading dims, each ``(C,)`` float32. CUDA tensors launch
    ``csrc/bn_stats.cu``; CPU tensors take :func:`bn_stats_plain`."""
    del tile_rows, interpret  # Mosaic tiling hints
    return tuple(bn_sums(x).unbind(0))


bn_stats.launches = 0


def bn_grad_stats(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                  invstd: torch.Tensor, *, tile_rows: int = 0,
                  interpret: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(sum(dy), sum(dy * xhat))`` with
    ``xhat = (x - mean) * invstd`` in float32: the two reductions of the
    BatchNorm backward. ``dy`` and ``x`` are ``(..., C)`` of one dtype,
    ``mean`` and ``invstd`` ``(C,)``. CUDA tensors launch
    ``csrc/bn_stats.cu``; CPU tensors take :func:`bn_grad_stats_plain`."""
    del tile_rows, interpret  # Mosaic tiling hints
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} must match")
    c = x.shape[-1]
    if tuple(mean.shape) != (c,) or tuple(invstd.shape) != (c,):
        raise ValueError(f"mean and invstd must be ({c},), got "
                         f"{tuple(mean.shape)} and {tuple(invstd.shape)}")
    devices = {t.device for t in (dy, x, mean, invstd)}
    if len(devices) != 1:
        raise ValueError(f"dy, x, mean and invstd on "
                         f"{sorted(map(str, devices))}")
    dy2, x2 = _rows(dy, "bn_grad_stats"), _rows(x, "bn_grad_stats")
    if _device(x) == "cpu":
        return bn_grad_stats_plain(dy2, x2, mean, invstd)
    stats = (mean.float().contiguous(), invstd.float().contiguous())
    return tuple(_reduce(_lib().vnet_bn_grad_stats, bn_grad_stats,
                         (dy2, x2), stats, "bn_grad_stats").unbind(0))


bn_grad_stats.launches = 0


def fused_bias_prelu_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                                    bias: torch.Tensor,
                                    alpha: torch.Tensor) -> torch.Tensor:
    """``t = (x + bias) + residual``, ``max(t, 0) + alpha * min(t, 0)``,
    one PyTorch operator at a time in ``x``'s dtype; any device. ``bias`` and
    ``alpha`` must promote with ``x`` to ``x``'s dtype (see
    :func:`fused_bias_prelu_residual`)."""
    t = (x + bias.to(x.dtype)) + residual
    return torch.clamp_min(t, 0) + alpha.to(x.dtype) * torch.clamp_max(t, 0)


@functools.cache
def _tail_kernel():
    fn = build.load("bias_prelu_residual").lib.vnet_bias_prelu_residual
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_bias_prelu_residual(x: torch.Tensor, residual: torch.Tensor,
                              bias: torch.Tensor, alpha: torch.Tensor, *,
                              interpret: bool = False) -> torch.Tensor:
    """``prelu(x + bias + residual)`` with per-channel ``bias`` and
    ``alpha`` ``(C,)``, in ``x``'s dtype; ``x`` and ``residual`` are
    ``(..., C)`` of one shape and dtype. ``bias`` and ``alpha`` must promote
    with ``x`` to ``x``'s dtype (their own, or a narrower float type for a
    float32 ``x``), as the TPU kernel, which stores the promoted result into
    an ``x``-typed output, requires. Returns a new contiguous tensor. CUDA
    tensors launch ``csrc/bias_prelu_residual.cu``; CPU tensors take
    :func:`fused_bias_prelu_residual_plain`."""
    del interpret  # Mosaic hint
    if x.dtype not in _DTYPES or residual.dtype != x.dtype:
        raise TypeError(f"x and residual must share a float32, bfloat16 or "
                        f"float16 dtype, got {x.dtype} and {residual.dtype}")
    for name, t in (("bias", bias), ("alpha", alpha)):
        if (t.dtype not in _DTYPES
                or torch.promote_types(x.dtype, t.dtype) != x.dtype):
            raise TypeError(f"{name} {t.dtype} does not promote with x "
                            f"{x.dtype} to {x.dtype}")
    if x.shape != residual.shape or x.dim() < 1:
        raise ValueError(f"x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} must match")
    c = x.shape[-1]
    if tuple(bias.shape) != (c,) or tuple(alpha.shape) != (c,):
        raise ValueError(f"bias and alpha must be ({c},), got "
                         f"{tuple(bias.shape)} and {tuple(alpha.shape)}")
    devices = {t.device for t in (x, residual, bias, alpha)}
    if len(devices) != 1:
        raise ValueError(f"x, residual, bias and alpha on "
                         f"{sorted(map(str, devices))}")
    if _device(x) == "cpu":
        return fused_bias_prelu_residual_plain(x, residual, bias, alpha)
    x2, r2 = x.contiguous(), residual.contiguous()
    b = bias.to(x.dtype).contiguous()
    a = alpha.to(x.dtype).contiguous()
    out = torch.empty_like(x2)
    if out.numel() == 0:
        return out
    vec = int(_aligned(x2, r2, out))
    fn = _tail_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2.data_ptr(), r2.data_ptr(), b.data_ptr(), a.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], out.numel(), c, vec,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_bias_prelu_residual launch failed: CUDA "
                           f"error {err}")
    fused_bias_prelu_residual.launches += 1
    return out


fused_bias_prelu_residual.launches = 0
