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
kernel (``csrc/blend_rows.cu``) owns rows tile by tile and walks each tile's
segments in index order (:func:`plan_row_tiles`, built on the device), so
overlapping segments add in segment order in one launch.

Each wrapper launches its kernel for CUDA tensors and uses its plain version
only for CPU tensors; a CUDA tensor never falls back. Each wrapper's
``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

MAX_PATCHES_PER_LAUNCH = 256  # VNET_BLEND_MAX_PATCHES in the .cu source
ROW_BLOCK = 256  # VNET_ROWS_THREADS in csrc/blend_rows.cu


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
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(acc, contrib, starts):
    fn = _kernel()
    starts = starts.contiguous()
    width = ctypes.c_int(0)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), contrib.data_ptr(), starts.data_ptr(),
                 contrib.shape[0], *acc.shape, *contrib.shape[1:4],
                 ctypes.byref(width), stream)
    if err != 0:
        raise RuntimeError(f"blend_accumulate launch failed: CUDA error "
                           f"{err}")
    blend_accumulate_patches.launches += 1
    blend_accumulate_patches.last_width = width.value


def blend_accumulate_patches(acc: torch.Tensor, contrib: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """``acc[s_b : s_b + patch] += contrib[b]`` for b = 0..B-1 in order.

    Args:
      acc: ``(X, Y, Z, C)`` float32, contiguous; updated in place.
      contrib: ``(B, PX, PY, PZ, C)`` float32 on ``acc``'s device.
      starts: ``(B, 3)`` int32 patch corners on the CPU (launch metadata,
        passed to the kernel by value); any value inside the volume.
    Returns ``acc``. More than ``MAX_PATCHES_PER_LAUNCH`` patches take
    several launches, in order. ``.last_width`` is the floats per element
    of the last launch: 4 on the kernel's float4 path, 1 on its float path.
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
blend_accumulate_patches.last_width = 0


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


def row_tile(rows: int) -> int:
    """Rows per tile of the row blend: a power of two, at least the
    kernel's block of 256 threads and at least ``rows``, so that a segment
    meets at most two tiles."""
    return max(ROW_BLOCK, 1 << (rows - 1).bit_length())


def plan_row_tiles(row_starts: torch.Tensor, rows: int, tile: int,
                   num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment lists of the row tiles, as a CSR on ``row_starts``' device.

    Tile ``t`` holds rows ``[t * tile, (t + 1) * tile)`` of ``num_rows``;
    its list is ``seg_idx[tile_ptr[t] : tile_ptr[t + 1]]``, the segments of
    ``rows`` rows with ``s_i < (t + 1) * tile`` and ``s_i + rows > t *
    tile``, in increasing index. Returns ``(tile_ptr, seg_idx)``, int32;
    ``seg_idx`` may run on past ``tile_ptr[-1]`` with entries of no tile.

    Needs ``tile >= rows``: each segment then meets its first tile and at
    most one more. The (tile, index) keys are emitted in index order and
    sorted stably by tile, so each list keeps index order; a segment inside
    one tile gives its second key the tile count, which sorts past every
    list. Index bookkeeping only: it runs wherever the starts are, without
    a synchronisation.
    """
    if tile < rows:
        raise ValueError(f"tile {tile} shorter than the segments ({rows})")
    num_tiles = -(-num_rows // tile)
    first = torch.div(row_starts, tile, rounding_mode="floor")
    last = torch.div(row_starts + (rows - 1), tile, rounding_mode="floor")
    last = torch.where(last == first, num_tiles, last)
    keys, order = torch.sort(torch.stack((first, last), 1).reshape(-1),
                             stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=keys.dtype,
                          device=keys.device)
    tile_ptr = torch.searchsorted(keys, bounds, out_int32=True)
    return tile_ptr, torch.div(order, 2, rounding_mode="floor").int()


@functools.cache
def _rows_kernel():
    fn = build.load("blend_rows").lib.vnet_blend_rows
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
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
    Returns ``(acc, weight)``. CUDA tensors copy ``row_starts`` to the
    device, plan the row tiles there (:func:`plan_row_tiles`) and launch
    ``csrc/blend_rows.cu`` once (no segments: no launch); CPU tensors take
    :func:`blend_accumulate_rows_plain`.
    """
    del interpret  # Mosaic flag
    _check_rows(acc, weight, probs, window, row_starts)
    if acc.device.type == "cpu":
        return blend_accumulate_rows_plain(acc, weight, probs, window,
                                           row_starts)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    n, r, c = probs.shape
    big_r = acc.shape[0]
    tile = row_tile(r)
    num_tiles = -(-big_r // tile)
    if num_tiles * tile > 2 ** 31 - 1:
        raise ValueError(f"{big_r} rows: the row blend indexes rows with "
                         f"32-bit integers")
    if n == 0:
        return acc, weight
    fn = _rows_kernel()
    starts = row_starts.to(acc.device)
    tile_ptr, seg_idx = plan_row_tiles(starts, r, tile, big_r)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), weight.data_ptr(), probs.data_ptr(),
                 window.data_ptr(), starts.data_ptr(), tile_ptr.data_ptr(),
                 seg_idx.data_ptr(), num_tiles, tile, r, c, stream)
    if err != 0:
        raise RuntimeError(f"blend_rows launch failed: CUDA error {err}")
    blend_accumulate_rows.launches += 1
    return acc, weight


blend_accumulate_rows.launches = 0
