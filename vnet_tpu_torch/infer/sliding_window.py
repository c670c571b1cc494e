"""Overlap-tiled sliding-window inference, 2D or 3D, on one device or
sharded over data-parallel ranks.

Counterpart of ``vnet_tpu/infer/sliding_window.py``: the same patch grid
(strided starts with the last start clamped), the same padding of the grid
to whole batches (the last real row repeated with validity flag 0: it runs
through the network, so with ``Norm: batch_stats`` it feeds the batch
statistics exactly as in JAX, and adds zero blend weight), the same uniform
or cosine window and the optional hard-prediction channel.

A 3D grid blends into a channels-last ``(X, Y, Z, 1 + C)`` accumulator,
with the blend weight as channel 0, and the result is ``(acc[..., 1:],
acc[..., 0])`` as JAX's ``run_pallas`` returns it. A 2D grid runs over a
stack of slices (``slice_stacked``): the volume is ``(Z, H, W, C)``, the
rows are ``(z, i, j)``, every real z crossed with the ``(H, W)`` grid in
JAX's order, so batches straddle slices exactly as in JAX, and each
contribution is a ``(1, px, py)`` block of a ``(Z, H, W, 1 + C)``
accumulator: the same 3D blend with patch depth 1. The per-slice engine (a
2D engine without ``slice_stacked``, volume ``(H, W, C)``) is the stacked
engine on a stack of one slice; its rows and batches are JAX's per-slice
engine's. JAX's z bucket, which pads the stack to a multiple of 8 slices so
that one XLA compile serves several slice counts, is not ported: real rows
never reference the padded slices and the extra rows carry flag 0, so the
results are the same batch for batch.

``blend_impl`` picks how each batch is added:

* ``"auto"`` / ``"pallas"``: ``ops.blend.blend_accumulate_patches``, the
  CUDA kernel on a CUDA device;
* ``"xla"``: ``ops.blend.blend_accumulate_plain``, per-patch slice-adds, the
  counterpart of JAX's XLA path.

Both are the same arithmetic in the same order.

``mesh`` (``parallel/mesh.py``) of R > 1 ranks shards the grid as JAX's
``mesh=`` does (``P(axis)`` under ``shard_map``): the grid is padded to a
multiple of ``batch_size * R``, rank r takes the r-th contiguous block of
the padded rows, runs its batches through its network (batch statistics
are the rank's own, as each device's are under ``shard_map``) and blends
them with the same blend into a full-size accumulator of its own; one
all-reduce sums the accumulators, blend weight included, so every rank
returns the whole volume's sums. The 3D and the slice-stacked 2D grids
take the same path. JAX refuses its Pallas blend with a mesh for a Mosaic
limit; the port's kernel has none, so the sharded grid uses it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blend import blend_accumulate_patches, blend_accumulate_plain
from ..parallel.mesh import Mesh
from ..profiler import span


def patch_starts_1d(dim: int, patch: int, stride: int) -> list:
    """Strided starts with last-start clamping."""
    n = int(math.ceil((dim - patch) / float(stride))) + 1
    n = max(n, 1)
    starts = []
    for i in range(n):
        s = i * stride
        if s + patch > dim:
            s = dim - patch
        starts.append(max(s, 0))
    return starts


def build_patch_grid(volume_shape: Sequence[int], patch_shape: Sequence[int],
                     stride: Sequence[int]) -> np.ndarray:
    """All patch start corners, ``(N, rank)`` int32, i/j(/k) order."""
    axes = [patch_starts_1d(volume_shape[i], patch_shape[i], stride[i])
            for i in range(len(patch_shape))]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def cosine_window(patch_shape: Sequence[int]) -> np.ndarray:
    """Separable Hann^1 window, floored so every voxel keeps support."""
    ws = []
    for p in patch_shape:
        x = (np.arange(p) + 0.5) / p
        ws.append(np.clip(np.sin(np.pi * x), 0.05, None))
    w = ws[0]
    for axis_w in ws[1:]:
        w = np.multiply.outer(w, axis_w)
    return w.astype(np.float32)


class SlidingWindowInference:
    """Overlap-tiled inference for one network on one device, or sharded
    over the ranks of ``mesh``.

    Args:
      apply_fn: ``apply_fn(patches) -> logits``, ``(B, *patch, C_in)`` to
        ``(B, *patch, num_classes)``, eval mode.
      patch_shape / stride: 2- or 3-tuples (``PatchShape`` /
        ``EvaluationSetting.Stride``).
      batch_size: patches per forward pass.
      num_classes: output channels.
      gaussian_blend: cosine-window blending instead of uniform.
      hard_accumulate: also accumulate the per-patch argmax (as float) in
        channel 0 of the returned accumulator (not with ``slice_stacked``,
        as in JAX).
      blend_impl: ``"auto"``, ``"pallas"`` (the blend kernel) or ``"xla"``
        (plain slice-adds).
      slice_stacked: a 2D patch grid over a stack of slices ``(Z, H, W,
        C)``.
      device: where the volume, the accumulators and the network run;
        ``"cuda"`` by default, which raises where torch sees no card.
      mesh: data-parallel ranks to shard the grid over (module docstring);
        ``None`` or one rank runs the whole grid here.
    """

    def __init__(self, apply_fn: Callable, patch_shape: Sequence[int],
                 stride: Sequence[int], batch_size: int, num_classes: int,
                 gaussian_blend: bool = False, hard_accumulate: bool = False,
                 blend_impl: str = "auto", slice_stacked: bool = False,
                 device="cuda", mesh: Optional[Mesh] = None):
        self.apply_fn = apply_fn
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.stride = tuple(int(s) for s in stride)
        self.rank = len(self.patch_shape)
        if self.rank not in (2, 3):
            raise ValueError(f"patch_shape must be 2D or 3D, got "
                             f"{self.patch_shape}")
        self.slice_stacked = bool(slice_stacked)
        if self.slice_stacked and self.rank != 2:
            raise ValueError("slice_stacked requires a 2D patch shape")
        if self.slice_stacked and hard_accumulate:
            raise ValueError("slice_stacked excludes hard_accumulate "
                             "(the legacy averaging mode is 3D-only)")
        self.batch_size = int(batch_size)
        self.num_classes = int(num_classes)
        self.hard_accumulate = bool(hard_accumulate)
        if blend_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"blend_impl must be 'auto'|'pallas'|'xla', "
                             f"got {blend_impl!r}")
        self.use_kernel = blend_impl in ("auto", "pallas")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.parallel else None
        self.blend_window = (cosine_window(self.patch_shape)
                             if gaussian_blend else
                             np.ones(self.patch_shape, np.float32))

    def _probs(self, patches: torch.Tensor) -> torch.Tensor:
        with span("vnet.engine.forward"):
            logits = self.apply_fn(patches)
            probs = torch.softmax(logits.float(), dim=-1)
            if self.hard_accumulate:
                pred = torch.argmax(probs, dim=-1).float()
                probs = torch.cat([pred[..., None], probs], dim=-1)
            return probs

    def device_volume(self, volume) -> torch.Tensor:
        """``volume`` as a float32 tensor on the engine's device: a tensor
        already there (and float32) is returned as it is, anything else
        (a numpy array, a host tensor) is copied there once."""
        if isinstance(volume, torch.Tensor):
            return volume.to(self.device, torch.float32)
        return torch.from_numpy(
            np.ascontiguousarray(volume, np.float32)).to(self.device)

    def __call__(self, volume):
        """Run the full grid over ``volume``: ``(X, Y, Z, C)`` in 3D, ``(Z,
        H, W, C)`` slice-stacked, ``(H, W, C)`` for one slice, at least
        patch-sized per patch axis; a numpy array or a tensor, which is
        used in place when it already lies on the engine's device as
        float32 (``device_volume``). Returns ``(softmax_sum, weight)`` as
        tensors on the device, over the volume's spatial axes:
        ``argmax(softmax_sum)`` is the label and ``softmax_sum / weight``
        the probability maps."""
        with span("vnet.engine.volume"):
            return self._run(volume)

    def _run(self, volume):
        vol = self.device_volume(volume)
        one_slice = self.rank == 2 and not self.slice_stacked
        if one_slice:
            vol = vol[None]
        stacked = self.rank == 2
        spatial = tuple(vol.shape[1:-1] if stacked else vol.shape[:-1])
        for i in range(self.rank):
            if spatial[i] < self.patch_shape[i]:
                raise ValueError(f"volume {tuple(vol.shape)} smaller than "
                                 f"patch {self.patch_shape}; pad first")
        starts = build_patch_grid(spatial, self.patch_shape, self.stride)
        block = self.patch_shape
        if stacked:
            # every real z crossed with the (H, W) grid, in JAX's order
            m, nz = starts.shape[0], vol.shape[0]
            zs = np.repeat(np.arange(nz, dtype=np.int32), m)
            starts = np.concatenate([zs[:, None], np.tile(starts, (nz, 1))],
                                    axis=-1)
            block = (1,) + self.patch_shape
        n, bsz = starts.shape[0], self.batch_size
        ranks = 1 if self.mesh is None else self.mesh.data
        total = -(-n // (bsz * ranks)) * bsz * ranks
        if total > n:
            starts = np.concatenate(
                [starts, np.repeat(starts[-1:], total - n, axis=0)])
        flags = np.zeros(total, np.float32)
        flags[:n] = 1.0
        if self.mesh is not None:  # the rank's contiguous block
            per = total // ranks
            block0 = self.mesh.rank * per
            starts = starts[block0:block0 + per]
            flags = flags[block0:block0 + per]

        dev = self.device
        window = torch.from_numpy(self.blend_window).to(dev)
        acc_channels = self.num_classes + (1 if self.hard_accumulate else 0)
        acc = torch.zeros(tuple(vol.shape[:-1]) + (1 + acc_channels,),
                          dtype=torch.float32, device=dev)
        blend = (blend_accumulate_patches if self.use_kernel
                 else blend_accumulate_plain)
        ones = (1,) * self.rank
        bx, by, bz = block

        for lo in range(0, len(starts), bsz):
            rows = starts[lo:lo + bsz]
            patches = torch.stack([vol[x:x + bx, y:y + by, z:z + bz]
                                   for x, y, z in rows.tolist()])
            patches = patches.reshape((bsz,) + self.patch_shape
                                      + (vol.shape[-1],))
            probs = self._probs(patches) * window[..., None]
            flag = torch.from_numpy(flags[lo:lo + bsz]).to(dev)
            wb = window[None, ..., None].expand(
                (bsz,) + self.patch_shape + (1,))
            contrib = (torch.cat([wb, probs], dim=-1)
                       * flag.view((bsz,) + ones + (1,)))
            blend(acc, contrib.reshape((bsz,) + block + (-1,)).contiguous(),
                  torch.from_numpy(rows))
        if self.mesh is not None:
            acc = self.mesh.sum(acc)
        if one_slice:
            acc = acc[0]
        return acc[..., 1:], acc[..., 0]
