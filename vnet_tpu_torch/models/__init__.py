"""Model zoo and factory — counterpart of ``vnet_tpu/models/__init__.py``.

The names of the JAX zoo: ``VNet`` and ``VNetLegacy`` (its
``legacy_double_norm`` topology), ``UNet`` and ``Dense`` (2D or 3D), and
the attention-gated ``AttentionVNet`` (3D; a 2D one raises
``NotImplementedError``, see ROADMAP.md). ``FCN`` raises as in JAX. The
port's own ``SwinUNETR`` (3D; MONAI's, ``swin_unetr.py``) has no JAX
counterpart.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..device import resolve_device
from .attention import (AttentionGatedVNet, AttentionModule, OutputModule,
                        attention_distance_loss)
from .dense import Dense
from .swin_unetr import DEPTHS, SwinUNETR
from .unet import UNet
from .vnet import VNet

NETWORKS = ("VNet", "VNetLegacy", "UNet", "Dense", "AttentionVNet",
            "SwinUNETR")


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
                  conv_impl: str = "packed", packed_target_lanes: int = 128,
                  dropout_impl: str = "xla", remat: bool = False,
                  legacy_double_norm: bool = False, dw_impl: str = "xla",
                  attention_channels: int = 64,
                  spatial_rank: int = 3,
                  patch_shape=None) -> torch.nn.Module:
    """Instantiate a network from config values, with JAX's defaults
    (``conv_impl="packed"``, ``packed_target_lanes=128``; UNet and Dense
    ReLU, the V-Nets PReLU). Parameters are initialised on the CPU from
    ``generator`` (flax's initialisers: Xavier uniform convs, truncated
    normal attention-head convs, LeCun normal dense kernels, zero biases,
    PReLU 0.1, unit BN scale) and then moved to ``device`` (``cuda`` unless
    the caller asks for the CPU; no CUDA device raises).
    ``AttentionVNet`` passes ``dropout_impl`` to the backbone and the heads
    and ``conv_impl``, ``packed_target_lanes``, ``legacy_double_norm`` and
    ``dw_impl`` to the backbone. ``spatial_rank`` (2 or 3) is the number of
    spatial axes, ``len(PatchShape)``; ``Dense`` needs ``patch_shape`` (its
    output layer has one unit per voxel and class). ``remat`` recomputes
    the conv blocks of ``VNet`` and ``VNetLegacy`` and, of
    ``AttentionVNet``, also both heads in the backward pass; UNet and Dense
    warn and ignore it, with ``DropoutImpl`` and ``DwImpl``, as in JAX.

    ``SwinUNETR`` (3D) takes ``num_channels`` as MONAI's ``feature_size``
    (its depths, heads, window and patch are MONAI's defaults,
    ``swin_unetr.DEPTHS``, ...), ``num_levels`` as its number of stages (4)
    and ``remat`` as ``use_checkpoint`` (each Swin block recomputed); its norms
    are MONAI's (LayerNorm, instance norm) whatever ``norm`` says, and it
    warns and ignores dropout, ``DropoutImpl`` and ``DwImpl``."""
    device = resolve_device(device)
    if name == "FCN":
        raise NotImplementedError("Network to be developed")
    if name not in NETWORKS:
        raise ValueError(f"Invalid network: {name!r}")
    if name in ("AttentionVNet", "SwinUNETR") and spatial_rank != 3:
        raise NotImplementedError(
            f"a 2D {name} is not ported to PyTorch yet (ROADMAP.md)")
    if name == "SwinUNETR":
        unsupported = [k for k, on in (("Dropout", dropout_rate > 0.0),
                                       ("DropoutImpl", dropout_impl != "xla"),
                                       ("DwImpl", dw_impl != "xla")) if on]
        if unsupported:
            warnings.warn(f"SwinUNETR does not implement "
                          f"{', '.join(unsupported)}; ignoring", stacklevel=2)
        if num_levels != len(DEPTHS):
            raise ValueError(f"NumLevels {num_levels} is not SwinUNETR's "
                             f"{len(DEPTHS)} stages")
        net = SwinUNETR(num_classes=num_classes, in_channels=in_channels,
                        feature_size=num_channels, dtype=dtype, remat=remat,
                        generator=generator)
        return net.to(device)
    if name in ("UNet", "Dense"):
        # plain dropout and convolutions: a VNet-only knob must not
        # silently no-op (vnet_tpu/models/__init__.py:507-516)
        unsupported = [k for k, on in (("DropoutImpl", dropout_impl != "xla"),
                                       ("DwImpl", dw_impl != "xla"),
                                       ("Remat", remat)) if on]
        if unsupported:
            warnings.warn(f"{name} does not implement "
                          f"{', '.join(unsupported)}; ignoring", stacklevel=2)
    if name == "UNet":
        net = UNet(num_classes=num_classes, in_channels=in_channels,
                   num_channels=num_channels, num_levels=num_levels,
                   num_convolutions=(num_convolutions[0]
                                     if isinstance(num_convolutions,
                                                   (list, tuple))
                                     else num_convolutions),
                   bottom_convolutions=bottom_convolutions,
                   dropout_rate=dropout_rate,
                   activation=activation or "relu", norm=norm, dtype=dtype,
                   generator=generator, conv_impl=conv_impl,
                   spatial_rank=spatial_rank)
        return net.to(device)
    if name == "Dense":
        if patch_shape is None:
            raise ValueError("Dense needs patch_shape")
        net = Dense(num_classes=num_classes, in_channels=in_channels,
                    patch_shape=tuple(patch_shape), num_levels=num_levels,
                    dropout_rate=dropout_rate,
                    activation=activation or "relu", norm=norm, dtype=dtype,
                    generator=generator)
        return net.to(device)
    kw = dict(num_classes=num_classes, in_channels=in_channels,
              num_channels=num_channels, num_levels=num_levels,
              num_convolutions=tuple(num_convolutions),
              bottom_convolutions=bottom_convolutions,
              dropout_rate=dropout_rate, activation=activation or "prelu",
              norm=norm, dtype=dtype, generator=generator,
              dropout_impl=dropout_impl, dw_impl=dw_impl,
              conv_impl=conv_impl, packed_target_lanes=packed_target_lanes,
              legacy_double_norm=legacy_double_norm or name == "VNetLegacy",
              remat=remat)
    if name == "AttentionVNet":
        net = AttentionGatedVNet(attention_channels=attention_channels, **kw)
    else:
        net = VNet(spatial_rank=spatial_rank, **kw)
    return net.to(device)


__all__ = ["VNet", "UNet", "Dense", "AttentionGatedVNet", "AttentionModule",
           "OutputModule", "SwinUNETR", "NETWORKS", "attention_distance_loss",
           "build_network", "eval_apply"]
