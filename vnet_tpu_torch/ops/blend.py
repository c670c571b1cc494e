"""Sliding-window blend accumulate: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterpart of ``vnet_tpu/ops/pallas/fused.py::blend_accumulate_patches``:
``acc[start_b + region] += contrib[b]`` for b in order, in place. The JAX
caller folds the channel axis into the last spatial axis for Mosaic's lane
tiling; the port keeps a channels-last ``(X, Y, Z, C)`` accumulator and
takes any start (``csrc/blend_accumulate.cu``).

``blend_accumulate_rows`` is the counterpart of ``::blend_accumulate_rows``,
the 1D building block: ``acc[s_i : s_i + r] += probs[i] * window`` and
``weight[s_i : s_i + r] += window`` for segments i in order, in place. Its
kernel (``csrc/blend_rows.cu``) runs one launch per overlap level
(:func:`row_levels`), so overlapping segments add in segment order.

Each wrapper launches its kernel for CUDA tensors and uses its plain version
only for CPU tensors; a CUDA tensor never falls back. Each wrapper's
``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import build

MAX_PATCHES_PER_LAUNCH = 256  # VNET_BLEND_MAX_PATCHES in the .cu source


def blend_accumulate_plain(acc: torch.Tensor, contrib: torch.Tensor,
                           starts: torch.Tensor) -> torch.Tensor:
    """Per-patch slice-adds in patch order, in place; any device."""
    px, py, pz = contrib.shape[1:4]
    for b, (sx, sy, sz) in enumerate(starts.tolist()):
        acc[sx:sx + px, sy:sy + py, sz:sz + pz] += contrib[b]
    return acc


def _check(acc, contrib, starts):
    if acc.dtype != torch.float32 or contrib.dtype != torch.float32:
        raise TypeError(f"acc and contrib must be float32, got {acc.dtype} "
                        f"and {contrib.dtype}")
    if acc.ndim != 4 or contrib.ndim != 5:
        raise ValueError(f"expected acc (X, Y, Z, C) and contrib "
                         f"(B, PX, PY, PZ, C), got {tuple(acc.shape)} and "
                         f"{tuple(contrib.shape)}")
    if contrib.shape[-1] != acc.shape[-1]:
        raise ValueError(f"channel mismatch: acc {tuple(acc.shape)}, "
                         f"contrib {tuple(contrib.shape)}")
    if acc.device != contrib.device:
        raise ValueError(f"acc on {acc.device}, contrib on {contrib.device}")
    if not (acc.is_contiguous() and contrib.is_contiguous()):
        raise ValueError("acc and contrib must be contiguous")
    if (starts.dtype != torch.int32 or starts.device.type != "cpu"
            or tuple(starts.shape) != (contrib.shape[0], 3)):
        raise ValueError(f"starts must be a CPU int32 tensor of shape "
                         f"({contrib.shape[0]}, 3), got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")
    patch = torch.tensor(contrib.shape[1:4], dtype=torch.int32)
    vol = torch.tensor(acc.shape[:3], dtype=torch.int32)
    if bool((starts < 0).any()) or bool((starts + patch > vol).any()):
        raise ValueError(f"patch starts out of range for volume "
                         f"{tuple(acc.shape[:3])} and patch "
                         f"{tuple(contrib.shape[1:4])}")


@functools.cache
def _kernel():
    fn = build.load("blend_accumulate").lib.vnet_blend_accumulate
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(acc, contrib, starts):
    fn = _kernel()
    starts = starts.contiguous()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), contrib.data_ptr(), starts.data_ptr(),
                 contrib.shape[0], *acc.shape, *contrib.shape[1:4], stream)
    if err != 0:
        raise RuntimeError(f"blend_accumulate launch failed: CUDA error "
                           f"{err}")
    blend_accumulate_patches.launches += 1


def blend_accumulate_patches(acc: torch.Tensor, contrib: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """``acc[s_b : s_b + patch] += contrib[b]`` for b = 0..B-1 in order.

    Args:
      acc: ``(X, Y, Z, C)`` float32, contiguous; updated in place.
      contrib: ``(B, PX, PY, PZ, C)`` float32 on ``acc``'s device.
      starts: ``(B, 3)`` int32 patch corners on the CPU (launch metadata,
        passed to the kernel by value); any value inside the volume.
    Returns ``acc``. More than ``MAX_PATCHES_PER_LAUNCH`` patches take
    several launches, in order.
    """
    _check(acc, contrib, starts)
    if acc.device.type == "cpu":
        return blend_accumulate_plain(acc, contrib, starts)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    for lo in range(0, contrib.shape[0], MAX_PATCHES_PER_LAUNCH):
        hi = lo + MAX_PATCHES_PER_LAUNCH
        _launch(acc, contrib[lo:hi], starts[lo:hi])
    return acc


blend_accumulate_patches.launches = 0


def blend_accumulate_rows_plain(acc: torch.Tensor, weight: torch.Tensor,
                                probs: torch.Tensor, window: torch.Tensor,
                                row_starts: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment slice-adds in segment order, in place; any device."""
    r = probs.shape[1]
    for i, s in enumerate(row_starts.tolist()):
        acc[s:s + r] += probs[i] * window
        weight[s:s + r] += window
    return acc, weight


def row_levels(row_starts, rows: int) -> np.ndarray:
    """Overlap level of each segment of ``rows`` rows, int64, from 1:
    ``1 + max(level of the earlier segments overlapping it)``.

    Segments i and j overlap iff ``|s_i - s_j| < rows``. The overlapping
    pairs come from the starts in sorted order (each start against its
    followers until one lies ``rows`` away); the levels are the longest
    paths of the pairs oriented by index, relaxed until nothing grows (as
    many rounds as the deepest chain)."""
    s = np.asarray(row_starts, np.int64).reshape(-1)
    level = np.ones(s.size, np.int64)
    order = np.argsort(s, kind="stable")
    ss = s[order]
    src, dst = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    cand = np.arange(max(s.size - 1, 0))
    d = 1
    while cand.size:
        cand = cand[cand + d < s.size]
        cand = cand[ss[cand + d] - ss[cand] < rows]
        a, b = order[cand], order[cand + d]
        src.append(np.minimum(a, b))
        dst.append(np.maximum(a, b))
        d += 1
    src, dst = np.concatenate(src), np.concatenate(dst)
    if not src.size:
        return level
    by_dst = np.argsort(dst, kind="stable")
    src, dst = src[by_dst], dst[by_dst]
    targets, first = np.unique(dst, return_index=True)
    while True:
        new = np.maximum.reduceat(level[src], first) + 1
        grow = new > level[targets]
        if not grow.any():
            return level
        level[targets[grow]] = new[grow]


def plan_rows(row_starts, rows: int) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Launch plan of :func:`blend_accumulate_rows`, on the host:
    ``(order, bounds)``, the segment indices sorted by level (int32) and
    level ``k``'s slice ``order[bounds[k] : bounds[k + 1]]``."""
    levels = row_levels(row_starts, rows)
    order = np.argsort(levels, kind="stable").astype(np.int32)
    depth = int(levels.max()) if levels.size else 0
    bounds = np.searchsorted(levels[order], np.arange(1, depth + 2))
    return order, tuple(int(b) for b in bounds)


def _check_rows(acc, weight, probs, window, row_starts):
    for name, t in (("acc", acc), ("weight", weight), ("probs", probs),
                    ("window", window)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
    if acc.ndim != 2 or probs.ndim != 3:
        raise ValueError(f"expected acc (R, C) and probs (N, r, C), got "
                         f"{tuple(acc.shape)} and {tuple(probs.shape)}")
    n, r, c = probs.shape
    big_r = acc.shape[0]
    if (acc.shape[1] != c or tuple(weight.shape) != (big_r, 1)
            or tuple(window.shape) != (r, 1)):
        raise ValueError(f"shapes do not fit: acc {tuple(acc.shape)}, weight "
                         f"{tuple(weight.shape)}, probs {tuple(probs.shape)}, "
                         f"window {tuple(window.shape)}")
    if (row_starts.dtype != torch.int32 or row_starts.device.type != "cpu"
            or tuple(row_starts.shape) != (n,)):
        raise ValueError(f"row_starts must be a CPU int32 tensor of shape "
                         f"({n},), got {row_starts.dtype} "
                         f"{tuple(row_starts.shape)} on {row_starts.device}")
    if n and (int(row_starts.min()) < 0 or int(row_starts.max()) + r > big_r):
        raise ValueError(f"row starts out of range for {big_r} rows and "
                         f"segments of {r}")


@functools.cache
def _rows_kernel():
    fn = build.load("blend_rows").lib.vnet_blend_rows
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blend_accumulate_rows(acc: torch.Tensor, weight: torch.Tensor,
                          probs: torch.Tensor, window: torch.Tensor,
                          row_starts: torch.Tensor, *, interpret: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``acc[s_i : s_i + r] += probs[i] * window`` and ``weight[s_i : s_i +
    r] += window`` for i = 0..N-1 in order, in place.

    Args:
      acc: ``(R, C)`` float32, contiguous; updated in place.
      weight: ``(R, 1)`` float32, contiguous; updated in place.
      probs: ``(N, r, C)`` float32 contributions.
      window: ``(r, 1)`` float32 blend weight.
      row_starts: ``(N,)`` int32 row offsets on the CPU (launch metadata).
      interpret: the Mosaic flag, ignored.
    Returns ``(acc, weight)``. CUDA tensors level ``row_starts`` on the host
    (:func:`plan_rows`) and launch ``csrc/blend_rows.cu`` once per overlap
    level; CPU tensors take :func:`blend_accumulate_rows_plain`.
    """
    del interpret  # Mosaic flag
    _check_rows(acc, weight, probs, window, row_starts)
    if acc.device.type == "cpu":
        return blend_accumulate_rows_plain(acc, weight, probs, window,
                                           row_starts)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    _, r, c = probs.shape
    order, bounds = plan_rows(row_starts.numpy(), r)
    order = torch.from_numpy(order).to(acc.device)
    starts = row_starts.to(acc.device)
    fn = _rows_kernel()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            err = fn(acc.data_ptr(), weight.data_ptr(), probs.data_ptr(),
                     window.data_ptr(), order.data_ptr() + 4 * lo,
                     starts.data_ptr(), hi - lo, r, c, stream)
            if err != 0:
                raise RuntimeError(f"blend_rows launch failed: CUDA error "
                                   f"{err}")
            blend_accumulate_rows.launches += 1
    return acc, weight


blend_accumulate_rows.launches = 0
