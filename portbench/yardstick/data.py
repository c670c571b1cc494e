"""Inputs and weights from the run's seed, made on the card in a few large
calls, the same for the program and the reference.

Seeds are split by purpose (``sub_seed``), so the weights, each batch and
each volume draw from generators of their own. Every seed gets the same
amount of work: the same shapes and sizes, in another order.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, purpose: str) -> int:
    """A 62-bit seed for ``purpose`` under the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).hexdigest()
    return int(digest[:15], 16)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def permutation(seed: int, purpose: str, n: int) -> List[int]:
    """A permutation of ``range(n)`` drawn from the seed (on the host)."""
    g = torch.Generator().manual_seed(sub_seed(seed, purpose))
    return torch.randperm(n, generator=g).tolist()


def make_weights(named_shapes: Sequence[Tuple[str, tuple]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 parameters and batch-norm buffers for the names and shapes
    of a network: one uniform draw on ``device`` for every parameter, each
    leaf scaled by its kind: convolution kernels ``(O, I, *k)`` (a
    transpose convolution's ``(I, O, *k)``) Xavier-uniform, their biases
    within +-0.05, batch-norm scales 1 +- 0.1 and shifts +- 0.1, PReLU
    slopes 0.1 +- 0.05; running means 0 and variances 1."""
    params = [(n, s) for n, s in named_shapes
              if not n.endswith(("running_mean", "running_var"))]
    total = sum(math.prod(s) for _, s in params)
    u = torch.rand(total, generator=generator(seed, "weights", device),
                   device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in named_shapes:
        if name.endswith("running_mean"):
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.endswith("running_var"):
            out[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        v = u[at:at + n].view(shape)
        at += n
        if len(shape) >= 3:
            rf = math.prod(shape[2:])
            v = v * math.sqrt(6.0 / (rf * (shape[0] + shape[1])))
        elif name.endswith("bn.weight"):
            v = 1.0 + 0.1 * v
        elif name.endswith("prelu.weight"):
            v = 0.1 + 0.05 * v
        elif name.endswith("bn.bias"):
            v = 0.1 * v
        else:  # a convolution's bias
            v = 0.05 * v
        out[name] = v.contiguous()
    return out


def _field(gen: torch.Generator, batch: int, size: Sequence[int],
           coarse: Sequence[int], device) -> torch.Tensor:
    """A smooth random field ``(batch, *size)`` of unit scale: normal noise
    on a grid ``coarse`` times coarser, trilinear up to ``size``."""
    grid = [max(2, -(-s // c) + 1) for s, c in zip(size, coarse)]
    low = torch.randn((batch, 1, *grid), generator=gen, device=device)
    up = F.interpolate(low, size=tuple(size), mode="trilinear",
                       align_corners=True)[:, 0]
    return up / up.std().clamp_min(1e-6)


def train_batch(seed: int, index: int, batch: int, patch: Sequence[int],
                channels: int, classes: int, attention: bool,
                device) -> dict:
    """One host batch as the loader hands it: ``images`` ``(B, X, Y, Z,
    C)`` float32, ``labels`` ``(B, X, Y, Z)`` int32 and, for an attention
    network, ``distance_maps`` ``(B, X, Y, Z)`` float32 in [0, 1] (1 at the
    foreground's cores, 0 outside). Labels are thresholds of a smooth
    field; each channel is a class-dependent intensity plus noise."""
    gen = generator(seed, f"batch{index}", device)
    f = _field(gen, batch, patch, (16, 16, 8), device)
    if classes == 2:
        labels = (f > 0.5).to(torch.int32)
    else:
        labels = ((f > 0.0).to(torch.int32) + (f > 1.0).to(torch.int32))
    labels = labels.clamp_max(classes - 1)
    means = torch.linspace(-1.0, 1.5, classes, device=device)
    chans = []
    for c in range(channels):
        noise = torch.randn(f.shape, generator=gen, device=device)
        chans.append(means[labels.long()] * (1.0 + 0.5 * c) + 0.5 * noise)
    out = {"images": torch.stack(chans, dim=-1), "labels": labels}
    if attention:
        fg = f - 0.5
        top = fg.flatten(1).amax(1).clamp_min(1e-6).view(-1, 1, 1, 1)
        out["distance_maps"] = (fg / top).clamp(0.0, 1.0)
    return {k: v.cpu().numpy() for k, v in out.items()}


def volume(seed: int, index: int, shape: Sequence[int], channels: int,
           device) -> np.ndarray:
    """A host volume ``(X, Y, Z, C)`` float32: a smooth field in three
    intensity bands plus noise, as a normalised CT reads."""
    gen = generator(seed, f"volume{index}", device)
    f = _field(gen, 1, shape, (32, 32, 16), device)[0]
    base = (f > 0.0).float() + (f > 1.0).float() - 0.5
    chans = [base * (1.0 + 0.5 * c)
             + 0.3 * torch.randn(f.shape, generator=gen, device=device)
             for c in range(channels)]
    return torch.stack(chans, dim=-1).cpu().numpy()
