"""Space-to-depth packed convolutions — counterpart of
``vnet_tpu/ops/s2d.py``.

The V-Net's 5^r convolutions run on 16-64 channels at high resolution.
Packing a factor-2 space-to-depth transform into the layer turns the same
function into a convolution over ``G = prod(factors)`` times the channels:

    conv_{5^3, C->C, SAME}(x) == depth_to_space(
        conv_{3^3, 8C->8C}(space_to_depth(x), pack_kernel(w)))

``pack_kernel`` re-arranges the original kernel into the packed one (zeros
where a tap falls outside its support); the transform is exact for every
odd kernel on even extents and every per-axis packing (``factors``: 1
leaves an axis unpacked, 2 packs it; ``None`` packs every axis). The
stride-2 2^r down-convolution consumes one packed voxel per output voxel,
so it is a matrix product over the packed channels; the stride-2 2^r
transpose convolution is a matrix product and a depth-to-space.

Tensors are the port's: logical ``(B, C, *spatial)`` with channels-last
memory, the JAX layout ``(B, *spatial, C)`` in storage order. The packed
channel is ``offset_index * C + c``, the offsets lexicographic in axis order
(``vnet_tpu/ops/s2d.py:64``). :func:`space_to_depth` and
:func:`depth_to_space` are one copy each: a view of the storage as ``(B,
*spatial, C)``, a reshape, a permute, and one reshape that copies into the
result's channels-last storage. Convolution weights are the port's ``(O, I,
*k)``; transpose-convolution weights ``(I, O, *k)`` are stored already
spatially flipped (``convert.py``), so :func:`s2d_up_conv` does not flip
them again. The matrix products are ``torch.matmul``, as JAX computes them
with ``jnp.einsum`` outside any kernel. Spatial sharding (JAX's ``halo=``)
is :func:`packed_conv`'s ``halo``: the rank's slab exchanges its packed
pads with its neighbours (``parallel/spatial.py``).
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import unset_fake_temporarily

_CONV = {2: F.conv2d, 3: F.conv3d}


def norm_factors(factors, rank: int) -> Tuple[int, ...]:
    """Explicit per-axis factors (``None``: every axis packed by 2)."""
    if factors is None:
        return (2,) * rank
    factors = tuple(int(f) for f in factors)
    if len(factors) != rank or any(f not in (1, 2) for f in factors):
        raise ValueError(f"factors must be {rank} values of 1 or 2, got "
                         f"{factors}")
    return factors


def prod_factors(factors) -> int:
    return math.prod(factors)


def _storage(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, *spatial)`` -> its ``(B, *spatial, C)`` view (contiguous
    for a channels-last tensor)."""
    return x.movedim(1, -1)


def _logical(y: torch.Tensor) -> torch.Tensor:
    """``(B, *spatial, C)`` -> the logical ``(B, C, *spatial)`` view."""
    return y.movedim(-1, 1)


def space_to_depth(x: torch.Tensor, factor: int = 2,
                   factors=None) -> torch.Tensor:
    """``(B, C, *spatial)`` -> ``(B, prod(factors) * C, *spatial / f)``,
    offset-major channels; channels-last out."""
    rank = x.ndim - 2
    if factors is None:
        factors = (factor,) * rank
    factors = norm_factors(factors, rank)
    if all(f == 1 for f in factors):
        return x
    b, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
    new_shape = (b,)
    off_dims = []
    pos = 1
    for s, f in zip(spatial, factors):
        if s % f:
            raise ValueError(f"spatial dim {s} not divisible by {f}")
        if f == 1:
            new_shape += (s,)
            pos += 1
        else:
            new_shape += (s // f, f)
            off_dims.append(pos + 1)
            pos += 2
    y = _storage(x).reshape(new_shape + (c,))
    spatial_dims = [d for d in range(1, pos) if d not in off_dims]
    y = y.permute([0] + spatial_dims + off_dims + [pos])
    out_spatial = tuple(s // f for s, f in zip(spatial, factors))
    return _logical(y.reshape((b,) + out_spatial
                              + (prod_factors(factors) * c,)))


def depth_to_space(x: torch.Tensor, factor: int = 2,
                   factors=None) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    rank = x.ndim - 2
    if factors is None:
        factors = (factor,) * rank
    factors = norm_factors(factors, rank)
    g = prod_factors(factors)
    if g == 1:
        return x
    b, spatial = x.shape[0], tuple(x.shape[2:])
    c = x.shape[1] // g
    packed_axes = [i for i, f in enumerate(factors) if f == 2]
    y = _storage(x).reshape((b,) + spatial + (2,) * len(packed_axes) + (c,))
    perm = [0]
    for i in range(rank):
        perm.append(1 + i)
        if i in packed_axes:
            perm.append(1 + rank + packed_axes.index(i))
    perm.append(1 + rank + len(packed_axes))
    y = y.permute(perm)
    return _logical(y.reshape(
        (b,) + tuple(s * f for s, f in zip(spatial, factors)) + (c,)))


@lru_cache(maxsize=None)
def _packing_plan(k: int, factor: int = 2) -> Tuple[int, int, tuple]:
    """Per-axis plan: ``(kp, a_min, entries)`` — packed kernel extent, tap
    shift, and ``(packed tap a - a_min, in offset e, out offset d, original
    tap u + k//2)`` tuples. ``factor == 1`` is the identity plan."""
    h = k // 2
    if factor == 1:
        entries = tuple((u + h, 0, 0, u + h) for u in range(-h, h + 1))
        return k, -h, entries
    entries = []
    a_vals = set()
    for d in (0, 1):
        for u in range(-h, h + 1):
            a, e = divmod(d + u, 2)
            a_vals.add(a)
            entries.append((a, e, d, u + h))
    a_min, a_max = min(a_vals), max(a_vals)
    entries = tuple((a - a_min, e, d, t) for a, e, d, t in entries)
    return a_max - a_min + 1, a_min, entries


@lru_cache(maxsize=None)
def _pack_maps(k: int, rank: int,
               factors=None) -> Tuple[tuple, np.ndarray, np.ndarray]:
    """Constant gather map of :func:`pack_kernel`: ``(kp per axis,
    tap_index, mask)``, the arrays ``(prod(kp), G, G)`` over (packed tap,
    input offset e, output offset d): the flat original tap (or 0) and
    whether it exists. Offsets are mixed-radix over the packed axes in axis
    order, as :func:`space_to_depth` numbers them."""
    factors = norm_factors(factors, rank)
    plans = [_packing_plan(k, f) for f in factors]
    kps = tuple(p[0] for p in plans)
    n_off = prod_factors(factors)
    n_a = int(np.prod(kps))
    tap_index = np.zeros((n_a, n_off, n_off), np.int64)
    mask = np.zeros((n_a, n_off, n_off), bool)

    def idx_of(offs):
        v = 0
        for o, f in zip(offs, factors):
            v = v * f + o
        return v

    for axis_entries in itertools.product(*[p[2] for p in plans]):
        a_flat = t_flat = 0
        for (a, _, _, t), kpi in zip(axis_entries, kps):
            a_flat = a_flat * kpi + a
            t_flat = t_flat * k + t
        e = idx_of(tuple(en[1] for en in axis_entries))
        d = idx_of(tuple(en[2] for en in axis_entries))
        tap_index[a_flat, e, d] = t_flat
        mask[a_flat, e, d] = True
    return kps, tap_index, mask


@lru_cache(maxsize=None)
def _pack_gather(k: int, rank: int, factors: tuple, device: torch.device):
    """:func:`_pack_maps`'s tap index and mask as tensors on ``device``,
    made once: a copy from host memory at every call would make the host
    wait for the device's queue each time. Made outside inference mode, so
    that a first call under ``torch.inference_mode`` (evaluation) does not
    leave tensors that training cannot use, and outside any fake-tensor
    mode, so that a first call under ``torch.export`` caches real tensors,
    which the exported program then holds as constants."""
    _, tap_index, mask = _pack_maps(k, rank, factors)
    with torch.inference_mode(False), unset_fake_temporarily():
        return (torch.as_tensor(tap_index.reshape(-1), device=device),
                torch.as_tensor(mask, device=device))


def pack_kernel(weight: torch.Tensor, factor: int = 2, input_splits=None,
                factors=None) -> torch.Tensor:
    """``(O, I, k, ..., k)`` -> the packed ``(G * O, G * I, *kp)`` weight,
    channels offset-major as :func:`space_to_depth` makes them; per axis
    ``kp = 3`` for k = 5 on a packed axis, ``k`` on an unpacked one.
    Differentiable: a constant-index gather and a mask.

    ``input_splits=(C1, C2, ...)``, summing to I: the packed input is a
    flat channel concatenation of separately packed tensors (the decoder's
    ``cat([up, skip])`` on packed tensors), and the weight's input channels
    are ordered ``[(block, e, c in block)]`` to match."""
    if factor != 2:
        raise ValueError("only factor 2 is implemented")
    rank = weight.ndim - 2
    cout, cin, k = weight.shape[0], weight.shape[1], weight.shape[2]
    factors = norm_factors(factors, rank)
    n_off = prod_factors(factors)
    kps = _pack_maps(k, rank, factors)[0]
    n_a = int(np.prod(kps))
    index, keep = _pack_gather(k, rank, factors, weight.device)
    taps = weight.reshape(cout, cin, k ** rank)
    # (O, I, a, E, D) -> zero where no original tap lands
    gathered = taps.index_select(2, index).reshape(cout, cin, n_a, n_off,
                                                   n_off)
    gathered = gathered.masked_fill(~keep, 0)
    blocks = (cin,) if input_splits is None else tuple(input_splits)
    if sum(blocks) != cin:
        raise ValueError(f"input_splits {blocks} do not sum to {cin}")
    parts = []
    off = 0
    for cb in blocks:
        blk = gathered[:, off:off + cb]              # (O, cb, a, E, D)
        blk = blk.permute(4, 0, 3, 1, 2)             # (D, O, E, cb, a)
        parts.append(blk.reshape(n_off * cout, n_off * cb, *kps))
        off += cb
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def packed_pads(k: int, factors) -> list:
    """Per-axis ``(lo, hi)`` SAME padding in the packed domain."""
    pads = []
    for f in factors:
        kp, a_min, _ = _packing_plan(k, f)
        pads.append((-a_min, a_min + kp - 1))
    return pads


def pad_for_conv(x: torch.Tensor, pads):
    """``(x, padding)``: explicit per-axis ``(lo, hi)`` pads as a
    convolution's symmetric ``padding`` where they allow it, else ``x``
    padded and no padding."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat), (0,) * len(pads)


def conv_padded(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """Stride-1 convolution with explicit per-axis ``(lo, hi)`` pads."""
    x, padding = pad_for_conv(x, pads)
    return _CONV[w.ndim - 2](x, w, None, 1, padding)


def packed_conv(xp: torch.Tensor, weight: torch.Tensor, input_splits=None,
                factors=None, dw_impl: str = "xla",
                halo=None) -> torch.Tensor:
    """Stride-1 SAME convolution of an already packed ``xp`` by the
    original ``(O, I, *k)`` weight: ``s2d(conv(d2s(xp), weight))`` without
    the transposes.

    ``halo``: a spatial partition (``parallel/spatial.py``); ``xp`` is then
    the rank's slab, which exchanges the packed pads of the sharded axis
    with its neighbours in the packed domain (the unpacked pad on an axis
    the level leaves at factor 1) and convolves VALID there, with
    autograd's weight gradient (the dW kernel takes SAME operands only, as
    JAX's ``dw_conv_supported`` refuses a halo'd one).

    ``dw_impl``: ``"pallas"`` takes the weight gradient of a rank-3
    convolution from ``ops/dw_conv.py`` (the CUDA kernel on the card; a
    rank-2 one keeps autograd's, as JAX's ``conv_pallas_dw`` keeps XLA's
    where its kernel does not apply), ``"custom"`` from
    ``ops/conv_vjp.py``, ``"xla"`` from autograd; the same function."""
    rank = weight.ndim - 2
    k = weight.shape[2]
    if k % 2 == 0:
        raise ValueError(f"packed_conv takes odd kernels, got {k}")
    factors = norm_factors(factors, rank)
    packed = pack_kernel(weight, input_splits=input_splits, factors=factors)
    pads = packed_pads(k, factors)
    if halo is not None:
        from ..parallel.spatial import halo_exchange_asym
        lo, hi = pads[halo.axis]
        xp = halo_exchange_asym(xp, lo, hi, halo, 2 + halo.axis)
        pads[halo.axis] = (0, 0)
        if dw_impl == "custom":
            from .conv_vjp import conv_custom_dw
            return conv_custom_dw(xp, packed, tuple(map(tuple, pads)))
        return conv_padded(xp, packed, pads)
    if dw_impl == "pallas" and rank == 3:
        from .dw_conv import conv3d_dw
        # odd packed extents: the packed pads are conv3d_dw's SAME pads
        return conv3d_dw(xp, packed)
    if dw_impl == "custom":
        from .conv_vjp import conv_custom_dw
        return conv_custom_dw(xp, packed, tuple(map(tuple, pads)))
    return conv_padded(xp, packed, pads)


def _down_matrix(weight: torch.Tensor, factors) -> torch.Tensor:
    """``(O, I, 2, ..., 2)`` -> ``K[(e, i), o]`` with the tap axes in
    (unpacked, packed) order, the channel order that completing a partial
    packing produces."""
    rank = weight.ndim - 2
    cout, cin = weight.shape[:2]
    kern = weight.permute(*range(2, 2 + rank), 1, 0)   # (2, .., 2, I, O)
    u_axes = [i for i, f in enumerate(factors) if f == 1]
    p_axes = [i for i, f in enumerate(factors) if f == 2]
    kern = kern.permute(u_axes + p_axes + [rank, rank + 1])
    return kern.reshape(2 ** rank * cin, cout)


def packed_down_conv(xp: torch.Tensor, weight: torch.Tensor,
                     keep_packed: bool = False, factors=None) -> torch.Tensor:
    """Stride-2 2^r convolution of a packed input: one matrix product over
    the packed channels, unpacked output on the half-resolution grid.

    ``factors``: the input's per-axis packing; axes packed with factor 1
    are completed first (a narrow space-to-depth), their offsets landing
    channel-major. ``keep_packed`` (full factors only) emits the next
    level's packed layout: space-to-depth of ``xp`` and the same product
    per offset group."""
    rank = weight.ndim - 2
    if tuple(weight.shape[2:]) != (2,) * rank:
        raise ValueError(f"packed_down_conv takes 2^r kernels, got "
                         f"{tuple(weight.shape[2:])}")
    cout, cin = weight.shape[:2]
    factors = norm_factors(factors, rank)
    if any(f == 1 for f in factors):
        if keep_packed:
            raise ValueError("keep_packed needs full packing")
        xp = space_to_depth(xp, factors=tuple(3 - f for f in factors))
    k_mat = _down_matrix(weight, factors)
    if not keep_packed:
        return _logical(torch.matmul(_storage(xp), k_mat))
    groups = 2 ** rank
    xp2 = _storage(space_to_depth(xp))
    xg = xp2.reshape(xp2.shape[:-1] + (groups, groups * cin))
    y = torch.matmul(xg, k_mat)
    return _logical(y.reshape(xp2.shape[:-1] + (groups * cout,)))


def s2d_down_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-2 2^r convolution as one matrix product on the
    space-to-depth grid: ``s2d(x) @ K``, ``K[(e, i), o] = w[o, i, e...]``.
    """
    return packed_down_conv(space_to_depth(x), weight)


def s2d_up_conv(x: torch.Tensor, weight: torch.Tensor,
                keep_packed: bool = False,
                out_factors=None) -> torch.Tensor:
    """Stride-2 2^r transpose convolution as ``d2s(x @ K)`` with ``K[i,
    (d, o)] = w[i, o, d...]``: the port's ``(I, O, *k)`` weight is already
    the flipped kernel that ``lax.conv_transpose`` writes with.

    ``keep_packed``: return the packed layout on the pre-upsample grid
    instead; ``out_factors`` selects which axes stay packed (default all),
    the columns ordered ``(d_unpacked, d_packed, o)`` so that a partial
    depth-to-space leaves exactly the target's offset-major channels."""
    rank = weight.ndim - 2
    if tuple(weight.shape[2:]) != (2,) * rank:
        raise ValueError(f"s2d_up_conv takes 2^r kernels, got "
                         f"{tuple(weight.shape[2:])}")
    cin, cout = weight.shape[:2]
    kern = weight.permute(*range(2, 2 + rank), 0, 1)    # (2, .., 2, I, O)
    comp = None
    if keep_packed and out_factors is not None:
        out_factors = norm_factors(out_factors, rank)
        if any(f == 1 for f in out_factors):
            u_axes = [i for i, f in enumerate(out_factors) if f == 1]
            p_axes = [i for i, f in enumerate(out_factors) if f == 2]
            kern = kern.permute(u_axes + p_axes + [rank, rank + 1])
            comp = tuple(3 - f for f in out_factors)
    k_mat = kern.reshape(2 ** rank, cin, cout).movedim(1, 0).reshape(
        cin, 2 ** rank * cout)
    y = _logical(torch.matmul(_storage(x), k_mat))
    if comp is not None:
        return depth_to_space(y, factors=comp)
    return y if keep_packed else depth_to_space(y)


def s2d_conv(x: torch.Tensor, weight: torch.Tensor,
             halo=None) -> torch.Tensor:
    """SAME stride-1 convolution computed in the space-to-depth domain;
    equals the direct one for odd kernels on even extents. ``halo``: see
    :func:`packed_conv`."""
    if weight.shape[2] % 2 == 0:
        raise ValueError("s2d_conv takes odd kernels only")
    return depth_to_space(packed_conv(space_to_depth(x), weight, halo=halo))
