"""Whole-network spatial partitioning — counterpart of
``vnet_tpu/parallel/spatial.py``.

One spatial axis of a volume, or of a batch of patches, is split into
equal slabs over the ranks of a space group (``Mesh.space_group``), and the
whole network runs on each rank's slab: inside a partition
(:func:`spatial_partition_scope`) every stencil ``SpatialConv``
(``models/layers.py``) and packed convolution (``ops/s2d.py``) exchanges
halos with its ring neighbours (``parallel/halo.py``) and convolves VALID
along the sharded axis, SAME elsewhere; stride-2 down-convolutions, 2^r
up-convolutions and 1^r convolutions stay local on even slabs. Statistics
cross the slabs:

* batch norm averages its moments ``(E[x], E[x^2])`` over the partition
  (over the whole mesh in the trainer, whose batch statistics are the
  global batch's), eval-mode ``batch`` is pointwise on its running
  averages, ``batch_stats`` reduces at inference too; group and instance
  norm average their per-sample moments over the space group;
* the losses sum the Dice statistics over the space group and average the
  cross entropy (``ops/losses.py``), with a backward that is the identity
  and ``1 / S`` (every space rank holds the same loss);
* the trainer sums the parameter gradients over the space group and
  averages them over the data rows (``Mesh.average_gradients``);
* dropout draws the rank's slab of the mask of the unsharded tensor
  (``models/layers.py::Dropout``: the counter's row map).

Two ways in, as in JAX:

* :func:`spatial_sharded_forward` and :func:`spatial_sharded_train_step`,
  the explicit ``shard_map`` API: the network's packing is planned on the
  local extents, as ``shard_map`` traces the local program;
* the trainer's ``Mesh.SpaceParallel`` (``parallel/mesh.py::
  data_parallel`` enters :func:`mesh_partition_scope`): GSPMD plans the
  unsharded program, so the packing is planned on the global extents
  (``Partition.global_plan``), and the step's losses, gradients, running
  averages and dropout masks are the unsharded step's.

A partition needs ``dim % (shards * 2**levels) == 0`` along the sharded
axis and a bottom slab at least one conv halo wide
(:func:`validate_partition`).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .halo import halo_exchange_asym, shard_volume

_CTX: contextvars.ContextVar = contextvars.ContextVar("spatial_partition",
                                                      default=None)


@dataclass(frozen=True, eq=False)
class Partition:
    """The space group of a rank and the sharded axis: ``ranks`` (global,
    in slab order), this rank's ``index`` among them, the ``group``
    (``None``: the default group), the spatial ``axis`` (0 = the first
    spatial axis) and whether networks plan their packing on the global
    extents (``global_plan``, the trainer) or the local ones."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int
    axis: int
    global_plan: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)

    def global_extents(self, local) -> tuple:
        """The unsharded extents of a slab of extents ``local``."""
        out = list(local)
        out[self.axis] *= self.size
        return tuple(out)


def current_partition() -> Optional[Partition]:
    """The active partition, or None."""
    return _CTX.get()


def mesh_partition(mesh, spatial_axis: int = 0,
                   global_plan: bool = False) -> Partition:
    """The partition of ``mesh``'s space group along ``spatial_axis``."""
    return Partition(mesh.space_group, mesh.space_ranks, mesh.space_index,
                     int(spatial_axis), global_plan)


@contextlib.contextmanager
def partition_scope(part: Optional[Partition]):
    """Make ``part``, a value :func:`current_partition` gave (``None``
    too), the active partition of the code inside."""
    token = _CTX.set(part)
    try:
        yield
    finally:
        _CTX.reset(token)


def spatial_partition_scope(mesh, spatial_axis: int,
                            global_plan: bool = False):
    """Run the code inside on this rank's slab of ``mesh``'s space axis,
    sharded along ``spatial_axis``."""
    return partition_scope(mesh_partition(mesh, spatial_axis, global_plan))


def mesh_partition_scope(mesh):
    """The trainer's partition: the first spatial axis over the space axis,
    packing planned on the global extents (JAX's ``batch_sharding``)."""
    return spatial_partition_scope(mesh, 0, global_plan=True)


class _PartitionSum(torch.autograd.Function):
    """The sum over the partition; every rank holds the same result and
    uses it alike, so the gradient of its own part is the incoming one."""

    @staticmethod
    def forward(ctx, x, part):
        out = x.detach().clone()
        dist.all_reduce(out, group=part.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def partition_sum(x: torch.Tensor, part: Optional[Partition]):
    """Differentiable sum of ``x`` over ``part`` (``x`` without one)."""
    if part is None or part.size == 1:
        return x
    return _PartitionSum.apply(x, part)


def partition_mean(x: torch.Tensor, part: Optional[Partition]):
    """Differentiable mean over ``part`` of a value that every rank then
    holds alike (a loss term): the backward is the incoming gradient over
    the partition's size."""
    if part is None or part.size == 1:
        return x
    return partition_sum(x, part) / part.size


def validate_partition(volume_shape, spatial_axis: int, shards: int,
                       num_levels: int, kernel_halo: int = 2) -> None:
    """Check that the sharded axis stays even through the encoder, so every
    down-convolution and packing stays local, and that the deepest level's
    slab still covers one conv halo (``kernel_halo = k // 2``, 2 for the
    V-Net's 5^r kernels)."""
    dim = volume_shape[spatial_axis]
    quantum = shards * (2 ** num_levels)
    if dim % quantum:
        raise ValueError(
            f"spatial axis {spatial_axis} (size {dim}) must be a multiple "
            f"of shards * 2**num_levels = {quantum} for halo-sharded "
            f"execution; pad the volume first")
    if dim // quantum < kernel_halo:
        raise ValueError(
            f"spatial axis {spatial_axis}: bottom-level local shard "
            f"{dim // quantum} is smaller than the conv halo "
            f"{kernel_halo}; use fewer shards or a larger volume")


def _gather(mesh, y: torch.Tensor, dim: int) -> torch.Tensor:
    """The slabs of the space group joined along ``dim``."""
    if mesh.space == 1:
        return y
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.space)]
    dist.all_gather(parts, y, group=mesh.space_group)
    return torch.cat(parts, dim=dim)


def spatial_sharded_forward(network, volume, mesh, spatial_axis: int = 0,
                            num_levels: Optional[int] = None,
                            gather: bool = True) -> torch.Tensor:
    """``network``'s inference forward of one volume ``(*spatial, C)``
    (numpy or torch, no batch axis), sharded along ``spatial_axis`` over
    ``mesh``'s space group: each rank runs the whole network on its slab.
    Returns the logits ``(*spatial, classes)`` joined over the group
    (``gather``), or the rank's slab of them. ``num_levels`` (default
    ``network.num_levels``) sets the divisibility check. Equals the
    unsharded forward (batch statistics of ``batch_stats`` included)."""
    rank = volume.ndim - 1
    if not 0 <= spatial_axis < rank:
        raise ValueError(f"spatial_axis {spatial_axis} out of range "
                         f"for rank-{rank} volume")
    levels = num_levels if num_levels is not None else getattr(
        network, "num_levels", 0)
    validate_partition(volume.shape, spatial_axis, mesh.space, levels)
    x = shard_volume(mesh, spatial_axis, volume)[None].float()
    network.eval()
    with torch.inference_mode(), spatial_partition_scope(mesh, spatial_axis):
        out = network(x)
    out = out[0] if not isinstance(out, tuple) else out[0][0]
    return _gather(mesh, out, spatial_axis) if gather else out


def spatial_sharded_train_step(network, mesh, *, loss_name: str,
                               num_classes: int, weights=(),
                               alpha: float = 1.0, spatial_axis: int = 0,
                               num_levels: Optional[int] = None):
    """A training step with activations sharded along one spatial axis over
    ``mesh``'s space group: train on patches larger than one card holds.

    Returns ``step(carry, images, labels, seed) -> (carry, loss)``:
    ``carry = (network, optimizer)`` (updated in place; the same weights on
    every rank), ``images`` ``(B, *spatial, C)`` and ``labels`` ``(B,
    *spatial)`` whole (numpy or torch; each rank takes its slab along
    ``1 + spatial_axis``), ``seed`` the step's dropout seed. Batch-norm
    moments are averaged over the partition, the loss statistics summed,
    the gradients summed over the space group before the optimizer; the
    loss (a float) is the unsharded step's. Dropout draws the rank's slab
    of the mask of the tensors this program packs (planned on the local
    extents, as under ``shard_map``)."""
    from ..ops.losses import segmentation_loss

    def step(carry, images, labels, seed: int = 0):
        net, opt = carry
        rank = images.ndim - 2
        if not 0 <= spatial_axis < rank:
            raise ValueError(f"spatial_axis {spatial_axis} out of range "
                             f"for rank-{rank} inputs")
        levels = num_levels if num_levels is not None else getattr(
            network, "num_levels", 0)
        validate_partition(images.shape[1:], spatial_axis, mesh.space,
                           levels)
        x = shard_volume(mesh, 1 + spatial_axis, images).float()
        y = shard_volume(mesh, 1 + spatial_axis, labels).long()
        net.train()
        opt.zero_grad(set_to_none=True)
        with spatial_partition_scope(mesh, spatial_axis):
            out = net(x, dropout_seed=seed)
            loss, _ = segmentation_loss(
                out, y, name=loss_name, num_classes=num_classes,
                weights=weights, alpha=alpha,
                partition=current_partition())
            loss.backward()
        if mesh.space > 1:
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            from .mesh import _coalesced
            _coalesced(grads, lambda flat: dist.all_reduce(
                flat, group=mesh.space_group))
        opt.step()
        return (net, opt), float(loss.detach())

    return step
