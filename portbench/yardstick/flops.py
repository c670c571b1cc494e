"""Model FLOPs, counted from a configuration's layer shapes.

Each convolution of the unpacked network costs ``2 * k^3 * Ci * Co`` per
output voxel (a stride-2 ``2^3`` convolution and its transpose: per
voxel of the coarse grid, ``2 * 8 * Ci * Co``), the arithmetic of the
port's ``tools/dw_bench.py::step_bound_ms``. Not counted: batch norm,
activations, dropout, the softmax gate, the loss, ``Remat``'s recompute
and the packed network's zero taps. So the count is the same whatever
implements the network. A training step is three forward passes. Each
configuration's forward count per input voxel lives beside its plain
reference, ``reference/<config>.py::flops_per_voxel``.
"""

from __future__ import annotations

import math


def conv(k: int, ci: int, co: int) -> int:
    """FLOPs per output voxel of a ``k^3`` convolution."""
    return 2 * k ** 3 * ci * co


def train_step(per_voxel, batch: int, patch) -> float:
    """Model FLOPs of one training step of a network whose forward costs
    ``per_voxel`` an input voxel: forward, and a backward of twice the
    forward."""
    return float(3 * per_voxel * batch * math.prod(patch))


def forward(per_voxel, patches: int, patch) -> float:
    """Model FLOPs of a forward pass over ``patches`` patches."""
    return float(per_voxel * patches * math.prod(patch))
