"""Bytes that the port's kernels must move, counted from the shapes: each
input byte read once, each output byte written once.

* Dropout (a frozen copy of ``tools/dropout_bench.py::bound_ms``'s
  arithmetic): a launch reads its input and writes its output,
  ``2 * numel * element_size``.
* Blend (the byte bound of the port's blend check): a launch reads its
  contributions once and reads and writes the accumulator over the union
  of its patches once, ``contrib + 2 * covered * channels * 4``.
"""

from __future__ import annotations

import math
from typing import Sequence


def dropout_launch(numel: int, element_size: int = 2) -> int:
    return 2 * int(numel) * int(element_size)


def box_union_volume(starts: Sequence[Sequence[int]],
                     size: Sequence[int]) -> int:
    """The number of grid cells in the union of the boxes ``[s, s +
    size)`` (one box a start), by coordinate compression."""
    starts = [tuple(int(v) for v in s) for s in starts]
    if not starts:
        return 0
    rank = len(size)
    cuts = [sorted({s[a] for s in starts} | {s[a] + size[a] for s in starts})
            for a in range(rank)]
    total = 0

    def walk(axis, cell_boxes, extent):
        nonlocal total
        if not cell_boxes:
            return
        if axis == rank:
            total += extent
            return
        cs = cuts[axis]
        for a, b in zip(cs, cs[1:]):
            inside = [s for s in cell_boxes
                      if s[axis] <= a and b <= s[axis] + size[axis]]
            walk(axis + 1, inside, extent * (b - a))

    walk(0, starts, 1)
    return total


def blend_launch(starts: Sequence[Sequence[int]], patch: Sequence[int],
                 channels: int) -> int:
    """Bytes of one blend launch over the patches at ``starts``: float32
    contributions of ``channels`` (the weight channel included) read once,
    the accumulator over their union read and written once."""
    contrib = len(starts) * math.prod(patch) * channels * 4
    return contrib + 2 * box_union_volume(starts, patch) * channels * 4
