"""Sliding-window blend accumulate: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``vnet_tpu/ops/pallas/fused.py::blend_accumulate_patches``:
``acc[start_b + region] += contrib[b]`` for b in order, in place. The JAX
caller folds the channel axis into the last spatial axis for Mosaic's lane
tiling; the port keeps a channels-last ``(X, Y, Z, C)`` accumulator and
takes any start (``csrc/blend_accumulate.cu``).

``blend_accumulate_patches`` launches the kernel for CUDA tensors and uses
``blend_accumulate_plain`` only for CPU tensors; a CUDA tensor never falls
back. ``blend_accumulate_patches.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

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
