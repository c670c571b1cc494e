"""Dropout with a counter-based generator: the CUDA kernel's wrapper, its
plain PyTorch version and the autograd Function around them.

Counterpart of ``vnet_tpu/ops/pallas/dropout.py::pallas_dropout`` and of
the three flavours of ``vnet_tpu/models/layers.py::Dropout``:

    out = where(u < thr, x * factor, 0)     (pallas, bits8)
    out = where(u < thr, x / factor, 0)     (xla)

``u`` is a 32-bit word of Philox4x32-10 keyed by ``(seed, stream)`` and
counted by the element's position in the JAX layout's ``(B, X, Y, Z, C)``
order, or ``(B, H, W, C)`` for the 2D network (``csrc/dropout.cu``), plus
a counter base: a data-parallel rank passes the number of elements of the
global batch's rows before its own, so its mask is those rows of the
global batch's mask, whatever the base's remainder mod 4 (one Philox call
covers four elements). A row map ``(row_len, row_stride)`` = ``(L, G)``
counts element ``i`` at ``base + (i // L) * G + i % L``: a rank of a
spatial partition holds ``n / L`` runs of ``L`` elements that lie ``G``
apart in the unsharded tensor, and so draws its slab of that tensor's mask;
``L = G`` (the default, ``0``) counts contiguously. The backward pass applies the same function to the
gradient with the same key and base, so nothing but the key is saved. The
threshold, factor and operation of each flavour (:func:`dropout_params`):

* ``pallas``: ``thr = min(round(keep * 2**32), 2**32 - 1)``, survivors
  times ``1 / keep`` (``dropout.py:42,49`` of the JAX kernel);
* ``bits8``: the top byte against ``t = clamp(round(keep * 256), 1, 255)``,
  survivors times ``256 / t`` (``layers.py:704-709``);
* ``xla``: the same threshold as ``pallas``, survivors divided by ``keep``,
  as flax's ``nn.Dropout`` computes ``inputs / keep_prob``.

The stream is not JAX's: JAX's own kernel already differs from flax's.
The factor is rounded to the tensor's dtype (JAX casts a Python scalar to
the array's dtype), and the product or quotient is taken in float32 and
rounded once to the dtype, as XLA computes a bf16 or f16 operation.

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
    """``(thr, factor, divide)`` of a dropout flavour: keep iff ``u32 <
    thr``; a survivor is ``x / factor`` when ``divide``, else ``x *
    factor``."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown dropout impl {impl!r}; expected 'xla', "
                         "'bits8' or 'pallas'")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    keep = 1.0 - float(rate)
    if impl == "bits8":
        t = min(max(int(round(keep * 256.0)), 1), 255)
        return t << 24, 256.0 / t, False
    thr = min(int(round(keep * 4294967296.0)), _MASK32)
    if impl == "xla":
        return thr, keep, True
    return thr, 1.0 / keep, False


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


def row_map(n: int, row_len: int = 0, row_stride: int = 0):
    """``(L, G)`` of a row map for ``n`` elements: ``0`` is one row of
    ``n``; checks ``0 < L <= G`` and that ``L`` divides ``n``."""
    row_len = int(row_len) or n
    row_stride = int(row_stride) or row_len
    if row_len < 1 or row_stride < row_len or n % row_len:
        raise ValueError(f"row map (row_len={row_len}, row_stride="
                         f"{row_stride}) does not fit {n} elements")
    return row_len, row_stride


def keep_mask(n: int, seed: int, stream: int, thr: int,
              device=None, base: int = 0, row_len: int = 0,
              row_stride: int = 0) -> torch.Tensor:
    """Boolean keep mask of the ``n`` elements from ``base`` on, in counter
    order, row by row under a row map ``(row_len, row_stride)``."""
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    row_len, row_stride = row_map(n, row_len, row_stride)
    if row_len < n and row_len != row_stride:
        return torch.cat([keep_mask(row_len, seed, stream, thr, device,
                                    base + r * row_stride)
                          for r in range(n // row_len)])
    lo, hi = base // 4, (base + n + 3) // 4
    parts = []
    for start in range(lo, hi, _PLAIN_GROUPS):
        counter = torch.arange(start, min(start + _PLAIN_GROUPS, hi),
                               dtype=torch.int64, device=device)
        parts.append((philox4x32_10(counter, seed, stream) < thr).reshape(-1))
    skip = base - 4 * lo
    return torch.cat(parts)[skip:skip + n]


_CHANNELS_LAST = {4: torch.channels_last, 5: torch.channels_last_3d}


def _storage_order(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its elements in counter order: a 4D ``(B, C, H, W)`` or 5D
    ``(B, C, X, Y, Z)`` tensor becomes a channels-last one (the JAX layout's
    order), any other a row-major contiguous one."""
    if x.dim() in _CHANNELS_LAST:
        return x.contiguous(memory_format=_CHANNELS_LAST[x.dim()])
    return x.contiguous()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """1-D view of a :func:`_storage_order` tensor in storage order."""
    if x.dim() in _CHANNELS_LAST:
        x = x.permute(0, *range(2, x.dim()), 1)
    return x.reshape(-1)


def _unflat(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() in _CHANNELS_LAST:
        b, c, *sp = like.shape
        return flat.view(b, *sp, c).permute(0, like.dim() - 1,
                                            *range(1, like.dim() - 1))
    return flat.view(like.shape)


@functools.cache
def _in_dtype(factor: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(factor, dtype=dtype))


def dropout_plain(x: torch.Tensor, seed: int, stream: int, thr: int,
                  factor: float, divide: bool, base: int = 0,
                  row_len: int = 0, row_stride: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch; any device."""
    xs = _storage_order(x)
    f = _in_dtype(factor, x.dtype)
    keep = keep_mask(xs.numel(), seed, stream, thr, x.device, base, row_len,
                     row_stride)
    xf = _flat(xs).float()
    # a 0-d tensor on x's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which can differ by one ulp
    f_t = torch.tensor(f, dtype=torch.float32, device=x.device)
    vals = (xf / f_t if divide else xf * f_t).to(x.dtype)
    flat = torch.where(keep, vals, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    return _unflat(flat, xs)


def bind(lib: ctypes.CDLL):
    """``lib.vnet_dropout`` with its C signature."""
    fn = lib.vnet_dropout
    fn.argtypes = ([ctypes.c_void_p] * 2
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int,
                      ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return bind(build.load("dropout").lib)


def dropout_apply(x: torch.Tensor, seed: int, stream: int, thr: int,
                  factor: float, divide: bool, base: int = 0,
                  row_len: int = 0, row_stride: int = 0) -> torch.Tensor:
    """``where(u < thr, x / factor if divide else x * factor, 0)`` with
    ``u`` from the key ``(seed, stream)`` counted from element ``base``
    under the row map ``(row_len, row_stride)`` (:func:`dropout_params`
    gives ``thr, factor, divide``); returns a new tensor, channels-last
    for 4D and 5D input. CUDA tensors launch ``csrc/dropout.cu``; CPU
    tensors take :func:`dropout_plain`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if base < 0:
        raise ValueError(f"counter base must be >= 0, got {base}")
    if x.numel():
        row_map(x.numel(), row_len, row_stride)
    if x.device.type == "cpu":
        return dropout_plain(x, seed, stream, thr, factor, divide, base,
                             row_len, row_stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = launch_with(_kernel(), x, seed, stream, thr, factor, divide, base,
                      row_len, row_stride)
    dropout_apply.launches += 1
    return out


def launch_with(fn, x: torch.Tensor, seed: int, stream: int, thr: int,
                factor: float, divide: bool, base: int = 0,
                row_len: int = 0, row_stride: int = 0) -> torch.Tensor:
    """Launch ``fn``, a ctypes function with ``vnet_dropout``'s interface,
    on a CUDA tensor ``x`` as :func:`dropout_apply` does, without counting
    (``tools/dropout_bench.py`` times other builds of the kernel with it)."""
    xs = _storage_order(x)
    out = torch.empty_like(xs)
    if xs.numel() == 0:
        return out
    x_ptr, out_ptr = xs.data_ptr(), out.data_ptr()
    row_len, row_stride = row_map(xs.numel(), row_len, row_stride)
    args = (x_ptr, out_ptr, xs.numel(), int(base), row_len, row_stride,
            _DTYPES[x.dtype],
            int(seed) & _MASK32, int(stream) & _MASK32, int(thr),
            _in_dtype(factor, x.dtype), int(bool(divide)),
            int((x_ptr | out_ptr) % 16 == 0))
    index = x.device.index
    # the raw stream handle, as Triton's launcher reads it: no Stream object
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"dropout launch failed: CUDA error {err}")
    return out


dropout_apply.launches = 0


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same masked scale under one key."""

    @staticmethod
    def forward(ctx, x, seed, stream, thr, factor, divide, base, row_len,
                row_stride):
        ctx.key = (seed, stream, thr, factor, divide, base, row_len,
                   row_stride)
        return dropout_apply(x, *ctx.key)

    @staticmethod
    def backward(ctx, g):
        return (dropout_apply(g, *ctx.key),) + (None,) * 8


def dropout(x: torch.Tensor, seed: int, stream: int, rate: float,
            impl: str = "pallas", base: int = 0, row_len: int = 0,
            row_stride: int = 0) -> torch.Tensor:
    """Differentiable dropout of ``x`` under the key ``(seed, stream)``,
    counted from element ``base`` under the row map ``(row_len,
    row_stride)``; ``rate`` in (0, 1), ``impl`` one of :data:`IMPLS`."""
    return _Dropout.apply(x, int(seed), int(stream),
                          *dropout_params(rate, impl), int(base),
                          int(row_len), int(row_stride))
