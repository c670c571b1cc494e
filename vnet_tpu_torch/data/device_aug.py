"""On-device augmentation tail — counterpart of ``vnet_tpu/data/device_aug.py``.

The reference runs every augmentation on the host per sample. With
``DeviceAugment`` the geometry-stable tail — intensity windowing, random
flips, additive Gaussian noise, random fixed-size crops — runs on the whole
batch where it already lies (the card), so the host only reads files and
resamples. Tensors keep the JAX layout: images ``(B, *spatial, C)``, labels
and distance maps ``(B, *spatial)``. All randomness comes from an explicit
``torch.Generator`` on the tensors' device, and every operation is a batched
tensor operation: no Python loop over samples or elements, and no value
read back to the host.

The random numbers are not JAX's (``torch.Generator`` is not a JAX key):
the tests hold the arithmetic with fixed coins, indices and noise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def window_normalize(images: torch.Tensor, window_min: float,
                     window_max: float, out_min: float = 0.0,
                     out_max: float = 255.0) -> torch.Tensor:
    """Intensity windowing (``ManualNormalization`` semantics)."""
    scale = (out_max - out_min) / max(window_max - window_min, 1e-12)
    out = (images - window_min) * scale + out_min
    return torch.clamp(out, out_min, out_max)


def flip_coins(generator: torch.Generator, batch: int,
               device) -> torch.Tensor:
    """One fair coin per sample, bool ``(batch,)`` on ``device``."""
    return torch.rand(batch, generator=generator, device=device) < 0.5


def flip_where(x: torch.Tensor, coins: torch.Tensor,
               axes: Sequence[int],
               mirror: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flip the samples of ``x`` (``(B, *spatial[, C])``) whose coin is
    set along every spatial axis in ``axes`` together. ``mirror``: ``x`` is
    slab ``s`` of ``S`` along spatial axis 0 (in ``axes``) and ``mirror``
    slab ``S - 1 - s``, whose flip is slab ``s`` of the flipped whole."""
    if not axes:
        return x
    flipped = torch.flip(x if mirror is None else mirror,
                         dims=[a + 1 for a in axes])
    sel = coins.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(sel, flipped, x)


def random_flip(generator: torch.Generator, images: torch.Tensor,
                labels: torch.Tensor, axes: Sequence[int]):
    """Each sample flips all ``axes`` together with p = 0.5 (``RandomFlip``
    semantics), images and labels with the same coin."""
    coins = flip_coins(generator, images.shape[0], images.device)
    return flip_where(images, coins, axes), flip_where(labels, coins, axes)


def random_noise(generator: torch.Generator, images: torch.Tensor,
                 sigma: float = 5.0, rows=None, slab=None) -> torch.Tensor:
    """Additive Gaussian noise (``RandomNoise``). ``rows``: ``(start, stop,
    n)``, ``images`` are rows ``start:stop`` of a batch of ``n`` and get
    those rows of the batch's noise (a data-parallel rank's share of one
    draw, so the ranks together add what one process adds). ``slab``:
    ``(start, stop, extent)``, ``images`` are that slab of spatial axis 0
    of patches ``extent`` long there, and get that slab of the noise."""
    start, stop, n = rows if rows is not None else (0, len(images),
                                                    len(images))
    shape = list(images.shape[1:])
    if slab is not None:
        shape[0] = slab[2]
    noise = torch.randn([n] + shape, generator=generator,
                        device=images.device, dtype=images.dtype)
    noise = noise[start:stop]
    if slab is not None:
        noise = noise[:, slab[0]:slab[1]]
    return images + sigma * noise


def crop_at(volume: torch.Tensor, label: torch.Tensor, start: torch.Tensor,
            patch_shape: Tuple[int, ...]):
    """The patch of ``volume`` (``(*spatial, C)``) and ``label``
    (``(*spatial)``) whose corner is the device tensor ``start``, clamped
    into the volume as ``lax.dynamic_slice`` clamps it; a gather, so the
    corner never goes to the host."""
    spatial = volume.shape[:-1]
    idx = []
    for axis, (n, p) in enumerate(zip(spatial, patch_shape)):
        s = torch.clamp(start[axis].long(), 0, n - p)
        shape = [1] * len(spatial)
        shape[axis] = p
        idx.append((s + torch.arange(p, device=volume.device)).view(shape))
    return volume[tuple(idx)], label[tuple(idx)]


def random_crop_from_candidates(generator: torch.Generator,
                                volume: torch.Tensor, label: torch.Tensor,
                                candidates: torch.Tensor,
                                patch_shape: Tuple[int, ...]):
    """Crop a patch whose corner is drawn uniformly from ``candidates``
    (``(K, rank)`` int, precomputed on the host, label-aware), the
    reference's ``RandomCrop`` rejection loop turned into a draw and a
    gather."""
    k = torch.randint(0, candidates.shape[0], (), generator=generator,
                      device=candidates.device)
    return crop_at(volume, label, candidates[k], patch_shape)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  labels: torch.Tensor, flip_axes: Tuple[int, ...] = (),
                  noise_sigma: float = 0.0,
                  window: Optional[Tuple[float, float]] = None):
    """The standard tail on one batch: window, flip, noise."""
    if window is not None:
        images = window_normalize(images, window[0], window[1])
    if flip_axes:
        images, labels = random_flip(generator, images, labels, flip_axes)
    if noise_sigma > 0.0:
        images = random_noise(generator, images, noise_sigma)
    return images, labels
