"""Model factory — counterpart of ``vnet_tpu/models/__init__.py``.

Only ``VNet`` is ported so far; the other names of the JAX zoo raise
``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .vnet import VNet

_NOT_PORTED = ("VNetLegacy", "UNet", "Dense", "AttentionVNet")


def eval_apply(network: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Inference-mode forward. ``Norm`` reads batch statistics or running
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
                  dropout_impl: str = "xla", dw_impl: str = "xla") -> VNet:
    """Instantiate a network from config values. Parameters are
    initialised on the CPU from ``generator`` (flax's initialisers: Xavier
    uniform convs, zero biases, PReLU 0.1, unit BN scale) and then moved to
    ``device`` (``cuda`` unless the caller asks for the CPU; no CUDA device
    raises)."""
    device = resolve_device(device)
    if name == "FCN":
        raise NotImplementedError("Network to be developed")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"network {name!r} is not ported to PyTorch yet (ROADMAP.md)")
    if name != "VNet":
        raise ValueError(f"Invalid network: {name!r}")
    net = VNet(num_classes=num_classes, in_channels=in_channels,
               num_channels=num_channels, num_levels=num_levels,
               num_convolutions=tuple(num_convolutions),
               bottom_convolutions=bottom_convolutions,
               dropout_rate=dropout_rate, activation=activation or "prelu",
               norm=norm, dtype=dtype, generator=generator,
               dropout_impl=dropout_impl, dw_impl=dw_impl)
    return net.to(device)


__all__ = ["VNet", "build_network", "eval_apply"]
