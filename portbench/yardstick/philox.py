"""The dropout's counter hash, a frozen copy: Philox4x32-10 keyed by
``(seed, stream)`` and counted by the element's position in the
``(B, X, Y, Z, C)`` order, four elements a call. The configuration's
dropout layers are numbered in module order (the stream); a step's seed
keys them all. With it the reference works out every mask again."""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57       # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85       # Weyl key increments
_CHUNK = 1 << 24                        # Philox calls a chunk


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for int64 ``a`` < 2^32."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (p0 >> 16)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = a_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32_10(counter: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """``(n, 4)`` int64 words (each < 2^32) of the counters ``(lo, hi, 0,
    0)`` under the key ``(k0, k1)``."""
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


def threshold(rate: float) -> int:
    """Keep iff the word is below this: ``round(keep * 2^32)``, at most
    ``2^32 - 1``."""
    return min(int(round((1.0 - float(rate)) * 4294967296.0)), _MASK32)


def keep_mask(shape, seed: int, stream: int, rate: float,
              device=None) -> torch.Tensor:
    """Boolean keep mask of a tensor of ``shape`` in the JAX layout ``(B,
    *spatial, C)``, element ``i`` of that order keyed by word ``i % 4`` of
    call ``i // 4``."""
    n = 1
    for s in shape:
        n *= int(s)
    thr = threshold(rate)
    out = torch.empty(n, dtype=torch.bool, device=device)
    calls = (n + 3) // 4
    for lo in range(0, calls, _CHUNK):
        hi = min(lo + _CHUNK, calls)
        counter = torch.arange(lo, hi, dtype=torch.int64, device=device)
        words = (philox4x32_10(counter, seed, stream) < thr).reshape(-1)
        end = min(4 * hi, n)
        out[4 * lo:end] = words[:end - 4 * lo]
    return out.view(*[int(s) for s in shape])
