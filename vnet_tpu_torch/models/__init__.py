"""Model factory — counterpart of ``vnet_tpu/models/__init__.py``.

``VNet`` (2D or 3D) and the attention-gated ``AttentionVNet`` (3D) are
ported; the other names of the JAX zoo, and a 2D ``AttentionVNet``, raise
``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .attention import (AttentionGatedVNet, AttentionModule, OutputModule,
                        attention_distance_loss)
from .vnet import VNet

_NOT_PORTED = ("VNetLegacy", "UNet", "Dense")


def eval_apply(network: torch.nn.Module, x: torch.Tensor):
    """Inference-mode forward: logits, or ``(logits, attention_logits)``
    for ``AttentionGatedVNet``. ``Norm`` reads batch statistics or running
    averages from its kind and the eval mode, so ``batch_stats`` needs no
    special handling here (unlike flax's mutable collection)."""
    network.eval()
    with torch.inference_mode():
        return network(x)


def build_network(name: str, *, num_classes: int, in_channels: int = 1,
                  dropout_rate: float = 0.01, num_channels: int = 16,
                  num_levels: int = 4, num_convolutions=(1, 2, 3, 3),
                  bottom_convolutions: int = 3, activation: str = None,
                  norm: str = "batch", dtype: torch.dtype = torch.float32,
                  device="cuda",
                  generator: Optional[torch.Generator] = None,
                  dropout_impl: str = "xla", dw_impl: str = "xla",
                  attention_channels: int = 64,
                  spatial_rank: int = 3) -> torch.nn.Module:
    """Instantiate a network from config values. Parameters are
    initialised on the CPU from ``generator`` (flax's initialisers: Xavier
    uniform convs, truncated-normal attention-head convs, zero biases,
    PReLU 0.1, unit BN scale) and then moved to ``device`` (``cuda`` unless
    the caller asks for the CPU; no CUDA device raises).
    ``AttentionVNet`` passes ``dropout_impl`` to the backbone and the heads
    and ``dw_impl`` to the backbone. ``spatial_rank`` (2 or 3) is the
    number of spatial axes, ``len(PatchShape)``."""
    device = resolve_device(device)
    if name == "FCN":
        raise NotImplementedError("Network to be developed")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"network {name!r} is not ported to PyTorch yet (ROADMAP.md)")
    if name not in ("VNet", "AttentionVNet"):
        raise ValueError(f"Invalid network: {name!r}")
    if name == "AttentionVNet" and spatial_rank != 3:
        raise NotImplementedError(
            "a 2D AttentionVNet is not ported to PyTorch yet (ROADMAP.md)")
    kw = dict(num_classes=num_classes, in_channels=in_channels,
              num_channels=num_channels, num_levels=num_levels,
              num_convolutions=tuple(num_convolutions),
              bottom_convolutions=bottom_convolutions,
              dropout_rate=dropout_rate, activation=activation or "prelu",
              norm=norm, dtype=dtype, generator=generator,
              dropout_impl=dropout_impl, dw_impl=dw_impl)
    if name == "AttentionVNet":
        net = AttentionGatedVNet(attention_channels=attention_channels, **kw)
    else:
        net = VNet(spatial_rank=spatial_rank, **kw)
    return net.to(device)


__all__ = ["VNet", "AttentionGatedVNet", "AttentionModule", "OutputModule",
           "attention_distance_loss", "build_network", "eval_apply"]
