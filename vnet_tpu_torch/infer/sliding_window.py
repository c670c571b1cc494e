"""Overlap-tiled sliding-window inference, 3D, one device.

Counterpart of ``vnet_tpu/infer/sliding_window.py`` for an unsharded 3D
grid: the same patch grid (strided starts with the last start clamped), the
same padding of the grid to whole batches (the last real row repeated with
validity flag 0: it runs through the network, so with ``Norm:
batch_stats`` it feeds the batch statistics exactly as in JAX, and adds zero
blend weight), the same uniform or cosine window and the optional
hard-prediction channel.

The blend weight rides as channel 0 of a channels-last ``(X, Y, Z, 1 + C)``
accumulator, and the result is ``(acc[..., 1:], acc[..., 0])`` as JAX's
``run_pallas`` returns it. ``blend_impl`` picks how each batch is added:

* ``"auto"`` / ``"pallas"``: ``ops.blend.blend_accumulate_patches`` — the
  CUDA kernel on a CUDA device;
* ``"xla"``: ``ops.blend.blend_accumulate_plain``, per-patch slice-adds, the
  counterpart of JAX's XLA path.

Both are the same arithmetic in the same order.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blend import blend_accumulate_patches, blend_accumulate_plain


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
    """All patch start corners, ``(N, rank)`` int32, i/j/k order."""
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
    """Overlap-tiled inference for one network on one device.

    Args:
      apply_fn: ``apply_fn(patches) -> logits``, ``(B, px, py, pz, C_in)``
        to ``(B, px, py, pz, num_classes)``, eval mode.
      patch_shape / stride: 3-tuples (``PatchShape`` /
        ``EvaluationSetting.Stride``).
      batch_size: patches per forward pass.
      num_classes: output channels.
      gaussian_blend: cosine-window blending instead of uniform.
      hard_accumulate: also accumulate the per-patch argmax (as float) in
        channel 0 of the returned accumulator.
      blend_impl: ``"auto"``, ``"pallas"`` (the blend kernel) or ``"xla"``
        (plain slice-adds).
      device: where the volume, the accumulators and the network run;
        ``"cuda"`` by default, which raises where torch sees no card.
    """

    def __init__(self, apply_fn: Callable, patch_shape: Sequence[int],
                 stride: Sequence[int], batch_size: int, num_classes: int,
                 gaussian_blend: bool = False, hard_accumulate: bool = False,
                 blend_impl: str = "auto", device="cuda"):
        self.apply_fn = apply_fn
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.stride = tuple(int(s) for s in stride)
        if len(self.patch_shape) != 3:
            raise NotImplementedError(
                "the port's sliding window is 3D only so far (ROADMAP.md)")
        self.batch_size = int(batch_size)
        self.num_classes = int(num_classes)
        self.hard_accumulate = bool(hard_accumulate)
        if blend_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"blend_impl must be 'auto'|'pallas'|'xla', "
                             f"got {blend_impl!r}")
        self.use_kernel = blend_impl in ("auto", "pallas")
        self.device = resolve_device(device)
        self.blend_window = (cosine_window(self.patch_shape)
                             if gaussian_blend else
                             np.ones(self.patch_shape, np.float32))

    def _probs(self, patches: torch.Tensor) -> torch.Tensor:
        logits = self.apply_fn(patches)
        probs = torch.softmax(logits.float(), dim=-1)
        if self.hard_accumulate:
            pred = torch.argmax(probs, dim=-1).float()
            probs = torch.cat([pred[..., None], probs], dim=-1)
        return probs

    def __call__(self, volume: np.ndarray):
        """Run the full grid over ``volume`` (``(X, Y, Z, C)``, at least
        patch-sized per axis). Returns ``(softmax_sum, weight)`` as tensors
        on the device: ``argmax(softmax_sum)`` is the label and
        ``softmax_sum / weight`` the probability maps."""
        spatial = tuple(volume.shape[:-1])
        for i in range(3):
            if spatial[i] < self.patch_shape[i]:
                raise ValueError(f"volume {tuple(volume.shape)} smaller than "
                                 f"patch {self.patch_shape}; pad first")
        starts = build_patch_grid(spatial, self.patch_shape, self.stride)
        n, bsz = starts.shape[0], self.batch_size
        total = -(-n // bsz) * bsz
        if total > n:
            starts = np.concatenate(
                [starts, np.repeat(starts[-1:], total - n, axis=0)])
        flags = np.zeros(total, np.float32)
        flags[:n] = 1.0

        dev = self.device
        vol = torch.from_numpy(
            np.ascontiguousarray(volume, np.float32)).to(dev)
        window = torch.from_numpy(self.blend_window).to(dev)
        px, py, pz = self.patch_shape
        acc_channels = self.num_classes + (1 if self.hard_accumulate else 0)
        acc = torch.zeros(spatial + (1 + acc_channels,), dtype=torch.float32,
                          device=dev)
        blend = (blend_accumulate_patches if self.use_kernel
                 else blend_accumulate_plain)

        for lo in range(0, total, bsz):
            rows = starts[lo:lo + bsz]
            patches = torch.stack([vol[x:x + px, y:y + py, z:z + pz]
                                   for x, y, z in rows.tolist()])
            probs = self._probs(patches) * window[..., None]
            flag = torch.from_numpy(flags[lo:lo + bsz]).to(dev)
            wb = window[None, ..., None].expand(bsz, px, py, pz, 1)
            contrib = (torch.cat([wb, probs], dim=-1)
                       * flag.view(bsz, 1, 1, 1, 1))
            blend(acc, contrib.contiguous(), torch.from_numpy(rows))
        return acc[..., 1:], acc[..., 0]
