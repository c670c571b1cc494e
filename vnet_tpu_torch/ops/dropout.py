"""Dropout with a counter-based generator: the CUDA kernel's wrapper, its
plain PyTorch version and the autograd Function around them.

Counterpart of ``vnet_tpu/ops/pallas/dropout.py::pallas_dropout`` and of
the three flavours of ``vnet_tpu/models/layers.py::Dropout``:

    out = where(u < thr, x * scale, 0)

``u`` is a 32-bit word of Philox4x32-10 keyed by ``(seed, stream)`` and
counted by the element's position in the JAX layout's ``(B, X, Y, Z, C)``
order (``csrc/dropout.cu``). The backward pass applies the same function to
the gradient with the same key, so nothing but the key is saved. The
threshold and scale of each flavour (:func:`dropout_params`):

* ``pallas``: ``thr = min(round(keep * 2**32), 2**32 - 1)``, scale
  ``1 / keep`` (``dropout.py:42,49`` of the JAX kernel);
* ``bits8``: the top byte against ``t = clamp(round(keep * 256), 1, 255)``,
  scale ``256 / t`` (``layers.py:704-709``);
* ``xla``: keep probability exact to 2^-32 and scale ``1 / keep``, as flax.

The stream is not JAX's: JAX's own kernel already differs from flax's.
The scale is rounded to the tensor's dtype and the product is rounded once,
as the JAX kernel multiplies in the tensor's dtype.

:func:`dropout_apply` launches the kernel for CUDA tensors and takes
:func:`dropout_plain` only for CPU tensors; a CUDA tensor never falls back.
``dropout_apply.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

IMPLS = ("xla", "bits8", "pallas")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57       # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85       # Weyl key increments
_PLAIN_GROUPS = 1 << 22                 # Philox calls per plain chunk


def dropout_params(rate: float, impl: str):
    """``(thr, scale)`` of a dropout flavour: keep iff ``u32 < thr``."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown dropout impl {impl!r}; expected 'xla', "
                         "'bits8' or 'pallas'")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    keep = 1.0 - float(rate)
    if impl == "bits8":
        t = min(max(int(round(keep * 256.0)), 1), 255)
        return t << 24, 256.0 / t
    return min(int(round(keep * 4294967296.0)), _MASK32), 1.0 / keep


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for int64 ``a`` < 2^32, from
    16-bit partial products so that nothing overflows int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (p0 >> 16)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = a_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32_10(counter: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """Philox4x32-10 of the int64 ``counter`` (as ``(lo, hi, 0, 0)``) under
    the key ``(k0, k1)``: ``(n, 4)`` int64 words, each < 2^32. The same
    rounds as ``philox4x32_10`` in ``csrc/dropout.cu``."""
    c0, c1 = counter & _MASK32, counter >> 32
    c2 = c3 = torch.zeros_like(counter)
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def keep_mask(n: int, seed: int, stream: int, thr: int,
              device=None) -> torch.Tensor:
    """Boolean keep mask of ``n`` elements in counter order."""
    groups = (n + 3) // 4
    parts = []
    for start in range(0, groups, _PLAIN_GROUPS):
        counter = torch.arange(start, min(start + _PLAIN_GROUPS, groups),
                               dtype=torch.int64, device=device)
        parts.append((philox4x32_10(counter, seed, stream) < thr).reshape(-1))
    return torch.cat(parts)[:n]


def _storage_order(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its elements in counter order: a 5D ``(B, C, X, Y, Z)``
    tensor becomes a channels-last one (the JAX layout's order), any other
    a row-major contiguous one."""
    if x.dim() == 5:
        return x.contiguous(memory_format=torch.channels_last_3d)
    return x.contiguous()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """1-D view of a :func:`_storage_order` tensor in storage order."""
    return (x.permute(0, 2, 3, 4, 1) if x.dim() == 5 else x).reshape(-1)


def _unflat(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 5:
        b, c, *sp = like.shape
        return flat.view(b, *sp, c).permute(0, 4, 1, 2, 3)
    return flat.view(like.shape)


def dropout_plain(x: torch.Tensor, seed: int, stream: int, thr: int,
                  scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch; any device."""
    xs = _storage_order(x)
    s = float(torch.tensor(scale, dtype=x.dtype))  # rounded to the dtype
    keep = keep_mask(xs.numel(), seed, stream, thr, x.device)
    flat = torch.where(keep, _flat(xs) * s, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return _unflat(flat, xs)


@functools.cache
def _kernel():
    fn = build.load("dropout").lib.vnet_dropout
    fn.argtypes = ([ctypes.c_void_p] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dropout_apply(x: torch.Tensor, seed: int, stream: int, thr: int,
                  scale: float) -> torch.Tensor:
    """``where(u < thr, x * scale, 0)`` with ``u`` from the key
    ``(seed, stream)``; returns a new tensor, channels-last for 5D input.
    CUDA tensors launch ``csrc/dropout.cu``; CPU tensors take
    :func:`dropout_plain`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return dropout_plain(x, seed, stream, thr, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xs = _storage_order(x)
    out = torch.empty_like(xs)
    if xs.numel() == 0:
        return out
    align = 4 * xs.element_size()
    vec = int(xs.data_ptr() % align == 0 and out.data_ptr() % align == 0)
    s = float(torch.tensor(scale, dtype=x.dtype))
    fn = _kernel()
    with torch.cuda.device(x.device):
        cuda_stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xs.data_ptr(), out.data_ptr(), xs.numel(), _DTYPES[x.dtype],
                 int(seed) & _MASK32, int(stream) & _MASK32, int(thr), s, vec,
                 cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout launch failed: CUDA error {err}")
    dropout_apply.launches += 1
    return out


dropout_apply.launches = 0


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same masked scale under one key."""

    @staticmethod
    def forward(ctx, x, seed, stream, thr, scale):
        ctx.key = (seed, stream, thr, scale)
        return dropout_apply(x, seed, stream, thr, scale)

    @staticmethod
    def backward(ctx, g):
        return dropout_apply(g, *ctx.key), None, None, None, None


def dropout(x: torch.Tensor, seed: int, stream: int, rate: float,
            impl: str = "pallas") -> torch.Tensor:
    """Differentiable dropout of ``x`` under the key ``(seed, stream)``;
    ``rate`` in (0, 1), ``impl`` one of :data:`IMPLS`."""
    thr, scale = dropout_params(rate, impl)
    return _Dropout.apply(x, int(seed), int(stream), thr, scale)
