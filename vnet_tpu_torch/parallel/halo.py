"""Halo exchange between the ranks of a spatial partition — counterpart of
``vnet_tpu/parallel/halo.py``.

A volume too large for one card is split along one spatial axis into equal
slabs, one a rank of a space group (``Mesh.space_group``); before each
stencil convolution every rank pads its slab with its ring neighbours'
boundary slabs (the *halos*, ``k // 2`` voxels for a ``k``-wide kernel) and
convolves VALID along that axis, which gives the unsharded SAME
convolution's slab exactly. The ring's ends get zeros, SAME's padding.

JAX compiles ``ppermute`` onto ICI; here :class:`_HaloExchange` posts the
sends and receives with ``torch.distributed``'s point-to-point operations,
both directions before waiting on either (a ring of two would deadlock
otherwise): ``batch_isend_irecv`` on ``nccl``, plain ``isend``/``irecv`` on
``gloo``, whose transport takes host tensors, so a CUDA slab under
``gloo`` (several ranks sharing one card) is staged through host memory.
The backward pass sends each halo's gradient back to the rank that owns
those voxels, which adds it to its slab's.

Tensors are ``(B, C, *spatial)`` (the port's logical layout, channels-last
in memory); a slab travels as a contiguous ``(B, *spatial, C)`` block.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
# what the exchanges of this process moved: calls, bytes sent, host seconds
# spent posting and waiting (read and reset by tools/sp_bench.py)
STATS = {"calls": 0, "bytes": 0, "host_s": 0.0}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous block with the channel axis last."""
    return t.movedim(1, -1).contiguous()


def _unwire(b: torch.Tensor) -> torch.Tensor:
    return b.movedim(-1, 1)


def _wire_buffer(x: torch.Tensor, dim: int, width: int,
                 zeros: bool = False) -> torch.Tensor:
    """An uninitialised (or zero) wire block of ``x``'s slab of ``width``
    along ``dim``."""
    shape = list(x.shape)
    shape[dim] = width
    shape = shape[:1] + shape[2:] + shape[1:2]
    make = torch.zeros if zeros else torch.empty
    return make(shape, dtype=x.dtype, device=x.device)


def _exchange(sends, recvs, group) -> None:
    """Post every send ``(tensor, peer)`` and receive ``(buffer, peer)``,
    then wait on all (peers are global ranks)."""
    if not sends and not recvs:
        return
    t0 = time.perf_counter()
    try:
        _post_and_wait(sends, recvs, group)
    finally:
        STATS["calls"] += 1
        STATS["bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        STATS["host_s"] += time.perf_counter() - t0


def _post_and_wait(sends, recvs, group) -> None:
    cuda = any(t.is_cuda for t, _ in sends + recvs)
    if cuda and dist.get_backend(group) == "nccl":
        ops = ([dist.P2POp(dist.isend, t, p, group) for t, p in sends]
               + [dist.P2POp(dist.irecv, b, p, group) for b, p in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return
    # gloo: host tensors only; stage CUDA slabs through pinned host memory
    host_sends = [(t.cpu() if t.is_cuda else t, p) for t, p in sends]
    host_recvs = [(torch.empty(b.shape, dtype=b.dtype,
                               pin_memory=b.is_cuda) if b.is_cuda else b, p)
                  for b, p in recvs]
    works = ([dist.isend(t, p, group) for t, p in host_sends]
             + [dist.irecv(b, p, group) for b, p in host_recvs])
    for work in works:
        work.wait()
    for (b, _), (h, _) in zip(recvs, host_recvs):
        if h is not b:
            b.copy_(h)


def _neighbours(part):
    """Global ranks of the left and right ring neighbours (None at an end
    of the ring, which receives zeros there)."""
    s, n = part.index, part.size
    left = part.ranks[s - 1] if s > 0 else None
    right = part.ranks[s + 1] if s < n - 1 else None
    return left, right


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lo: int, hi: int, part, dim: int):
        ctx.lo, ctx.hi, ctx.part, ctx.dim = lo, hi, part, dim
        size = x.shape[dim]
        if lo > size or hi > size:
            raise ValueError(f"halo ({lo}, {hi}) wider than the local slab "
                             f"of {size} along dim {dim}")
        left, right = _neighbours(part)
        sends, recvs = [], []

        def halo(width, peer):
            """A receive buffer from ``peer``, or zeros at the ring's end."""
            buf = _wire_buffer(x, dim, width, zeros=peer is None)
            if peer is not None:
                recvs.append((buf, peer))
            return _unwire(buf)

        parts = []
        if lo:
            if right is not None:  # our top lo slabs: right's low halo
                sends.append((_wire(x.narrow(dim, size - lo, lo)), right))
            parts.append(halo(lo, left))
        parts.append(x)
        if hi:
            if left is not None:  # our bottom hi slabs: left's high halo
                sends.append((_wire(x.narrow(dim, 0, hi)), left))
            parts.append(halo(hi, right))
        _exchange(sends, recvs, part.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi, part, dim = ctx.lo, ctx.hi, ctx.part, ctx.dim
        left, right = _neighbours(part)
        size = g.shape[dim] - lo - hi
        gx = g.narrow(dim, lo, size).clone()
        sends, recvs = [], []
        if lo:
            if left is not None:  # our low halo came from left's top slabs
                sends.append((_wire(g.narrow(dim, 0, lo)), left))
            if right is not None:
                recvs.append((_wire_buffer(gx, dim, lo), right))
        if hi:
            if right is not None:  # our high halo came from right's bottom
                sends.append((_wire(g.narrow(dim, lo + size, hi)), right))
            if left is not None:
                recvs.append((_wire_buffer(gx, dim, hi), left))
        _exchange(sends, recvs, part.group)
        # the receive buffers hold the neighbours' halo gradients
        k = 0
        if lo and right is not None:
            gx.narrow(dim, size - lo, lo).add_(_unwire(recvs[k][0]))
            k += 1
        if hi and left is not None:
            gx.narrow(dim, 0, hi).add_(_unwire(recvs[k][0]))
        return gx, None, None, None, None


def halo_exchange_asym(x: torch.Tensor, lo: int, hi: int, part,
                       dim: int) -> torch.Tensor:
    """``x`` grown by ``lo`` slabs from the left ring neighbour and ``hi``
    from the right along ``dim``; the ring's ends get zeros. ``part`` is
    the partition (``parallel/spatial.py::Partition``); differentiable."""
    if not lo and not hi:
        return x
    if part.size == 1:
        pads = [0, 0] * (x.dim() - dim - 1) + [lo, hi]
        return F.pad(x, pads)
    return _HaloExchange.apply(x, int(lo), int(hi), part, int(dim))


def halo_exchange(x: torch.Tensor, halo: int, part, axis: int
                  ) -> torch.Tensor:
    """Pad the local block with ``halo`` slabs from each ring neighbour
    along spatial ``axis`` of a ``(B, C, *spatial)`` tensor; the ring's ends
    get zeros (SAME semantics). Grows that axis by ``2 * halo``."""
    return halo_exchange_asym(x, halo, halo, part, 2 + axis)


def _same(k: int):
    return (k - 1) // 2, k // 2


def sharded_conv(mesh, spatial_axis: int):
    """A spatially sharded SAME convolution: ``conv(volume, weight)`` where
    ``volume`` is the rank's slab ``(*spatial, Cin)`` along
    ``spatial_axis`` (:func:`shard_volume`) and ``weight`` is ``(Cout, Cin,
    *k)``, the same on every rank; returns the rank's slab of the
    unsharded output ``(*spatial, Cout)``. Each rank convolves its slab
    after a halo exchange of ``k // 2`` slabs with its space group."""
    from .spatial import mesh_partition

    part = mesh_partition(mesh, spatial_axis)

    def conv(volume: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        rank = weight.dim() - 2
        k = weight.shape[2:]
        x = volume.movedim(-1, 0)[None]  # (1, Cin, *spatial)
        lo, hi = _same(k[spatial_axis])
        xh = halo_exchange_asym(x, lo, hi, part, 2 + spatial_axis)
        pads = [_same(kk) for kk in k]
        pads[spatial_axis] = (0, 0)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        y = _CONV[rank](F.pad(xh, flat), weight)
        return y[0].movedim(0, -1)

    return conv


def shard_volume(mesh, spatial_axis: int, volume) -> torch.Tensor:
    """The rank's slab of ``volume`` (numpy or torch) along its dimension
    ``spatial_axis`` (a spatial axis of a ``(*spatial, C)`` volume), on
    the mesh's device."""
    start, stop = mesh.slab(volume.shape[spatial_axis])
    if isinstance(volume, np.ndarray):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    return volume.narrow(spatial_axis, start, stop - start).to(mesh.device)
