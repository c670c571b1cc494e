"""Minimal tensor parallelism: a convolution's output channels split over
ranks — counterpart of ``vnet_tpu/parallel/tensor.py``.

At the V-Net's channel counts data and spatial parallelism dominate; tensor
parallelism only pays for research configs with hundreds of channels a
rank. As in JAX, no entry point calls it:

* :func:`make_tp_mesh` — a ``model`` axis of ranks (every rank of the
  group by default, a subgroup of the first ``model_parallel`` otherwise);
* :func:`shard_kernel` — the rank's ``Cout / M`` slice of a ``(Cout, Cin,
  *k)`` weight (column parallelism);
* :func:`replicate` — a tensor on the rank's device;
* :func:`tp_conv` — the SAME stride-1 convolution: each rank convolves its
  slice, one all-gather joins the channels.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import _world, rank_device

MODEL_AXIS = "model"
_CONV = {2: F.conv2d, 3: F.conv3d}
_GROUPS = {}


@dataclass(frozen=True, eq=False)
class TPMesh:
    """A ``model`` axis of ``size`` ranks: this rank's ``index`` on it, the
    process ``group`` (``None``: the default group) and the device."""

    size: int
    index: int
    group: Optional[object]
    device: torch.device


def make_tp_mesh(model_parallel: int = 0, device="cuda") -> TPMesh:
    """A ``(model,)`` axis over the first ``model_parallel`` ranks of the
    process group (0: all of them; one rank without a group). Every rank
    of the group must call it (it creates a subgroup for a partial axis);
    a rank outside the axis gets ``index`` -1."""
    world, rank = _world()
    if model_parallel <= 0:
        model_parallel = world
    if model_parallel > world:
        raise ValueError(f"model_parallel={model_parallel} needs "
                         f"{model_parallel} ranks, have {world}")
    group = None
    if 1 < model_parallel < world:
        if model_parallel not in _GROUPS:
            _GROUPS[model_parallel] = dist.new_group(
                list(range(model_parallel)))
        group = _GROUPS[model_parallel]
    index = rank if rank < model_parallel else -1
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return TPMesh(model_parallel, index, group,
                  rank_device(device, local_rank))


def _check(mesh: TPMesh, cout: int) -> None:
    if cout % mesh.size:
        raise ValueError(f"Cout={cout} not divisible by "
                         f"{MODEL_AXIS}={mesh.size}")


def shard_kernel(mesh: TPMesh, kernel: torch.Tensor) -> torch.Tensor:
    """The rank's ``Cout / M`` output channels of a ``(Cout, Cin, *k)``
    weight, on its device."""
    _check(mesh, kernel.shape[0])
    per = kernel.shape[0] // mesh.size
    return kernel[mesh.index * per:(mesh.index + 1) * per].to(mesh.device)


def replicate(mesh: TPMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` on the rank's device (every rank holds the same tensor)."""
    return x.to(mesh.device)


def tp_conv(mesh: TPMesh, x: torch.Tensor, kernel: torch.Tensor,
            padding: str = "SAME") -> torch.Tensor:
    """SAME (or VALID) stride-1 convolution of ``x`` ``(B, *spatial, Cin)``,
    the same on every rank, by the ``(Cout, Cin, *k)`` weight ``kernel``,
    its output channels split over the ``model`` axis: each rank convolves
    its ``Cout / M`` slice and one all-gather joins the channels. Returns
    ``(B, *spatial', Cout)``, equal to the unsharded convolution, on every
    rank."""
    _check(mesh, kernel.shape[0])
    rank = kernel.dim() - 2
    w = shard_kernel(mesh, kernel)
    xs = replicate(mesh, x).movedim(-1, 1)
    if padding == "SAME":
        pads = [((k - 1) // 2, k // 2) for k in kernel.shape[2:]]
        xs = F.pad(xs, [p for lo_hi in reversed(pads) for p in lo_hi])
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    y = _CONV[rank](xs, w).movedim(1, -1).contiguous()
    if mesh.size == 1:
        return y
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts, dim=-1)
