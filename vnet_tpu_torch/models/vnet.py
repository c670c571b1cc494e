"""V-Net, 2D or 3D, direct or packed convolutions — counterpart of
``vnet_tpu/models/vnet.py``, rank-generic as it is (``spatial_rank``).

Same topology and parameters as the JAX module (see its docstring); the
kernels below are 5^3 and 1^3 in 3D, 5^2 and 1^2 in 2D:

* input layer: a 1-channel input goes through ``TiledInputBatchNorm``
  (batch kinds) or is tiled to ``num_channels`` and normalised; a
  multichannel input gets a 5^3 conv + norm + activation;
* encoder level l: ``num_convolutions[l]`` x [5^3 conv, residual add of
  the block input at the last conv, norm, act, dropout], then a stride-2
  down-conv doubling channels;
* bottom: ``bottom_convolutions`` more residual convs;
* decoder level l: stride-2 transpose conv halving channels + norm + act,
  concat with the skip, then 5^3 convs 2n -> n with the residual taken
  from the up-convolved features (the JAX package's deliberate change from
  the TF reference, ``vnet_tpu/models/vnet.py:20-24``);
* output: 1^3 conv to ``num_classes``, then a norm **after** the logits.

``legacy_double_norm`` (the name ``VNetLegacy``) adds a second norm
``pre_norm_i`` right after each conv, before the residual add: on every
conv of an encoder or bottom block, and on every decoder conv but the first
of a multi-conv block (``DecoderConvBlock._pre_norm``).

``conv_impl`` selects the convolutions as JAX's ``VNet.conv_impl`` does:

* ``"direct"``: every convolution itself;
* ``"s2d"``/``"auto"``: per-site space-to-depth rewrites
  (``SpatialConv(impl="auto")``);
* ``"packed"``: whole conv blocks in the space-to-depth domain
  (``ops/s2d.py``). A level is packed by :meth:`VNet.level_packed`: with
  ``packed_target_lanes > 0`` (the trainer's 128) by
  :func:`adaptive_factors`, packing just enough leading even axes to reach
  that many packed channels; with 0 every axis of a level whose ``2^r``
  times its channels (decoder: twice them) is within ``packed_cap``. A
  packed encoder block keeps its output packed for the skip and the
  down-convolution (one matrix product); the up-convolution emits the
  decoder level's packed layout, whose first conv reads the flat packed
  concat ``[up, skip]`` (``packed_input_splits``); a packed last decoder
  level feeds the 1^r output conv (a grouped product) and the output norm
  packed, then one depth-to-space. The stride-2 convolutions of unpacked
  levels are the matrix products of ``s2d_down_conv``/``s2d_up_conv``, and
  an unpacked level's 5^r convs stay direct in adaptive mode
  (``fallback_impl``).

Packing depends on the input's extents, which JAX decides when it traces:
here :meth:`VNet.forward` decides it for each input, and the parameters
are the same in every mode, so any mode takes the same weights. Parameter
names do not depend on the rank, so ``convert.py`` maps 2D weights path by
path as it maps 3D ones. Compute runs in ``dtype`` (bfloat16 for
``Precision: bfloat16``) with float32 parameters; logits are returned in
float32.

Training: ``dropout_impl`` selects the dropout flavour of every block's
dropout layers and ``dw_impl`` the weight gradient of every stride-1
convolution (the block convolutions, packed or direct, the multichannel
input convolution and a direct 1^3 output convolution; ``"pallas"``: the
CUDA kernel, which is rank-3 only, so a 2D network keeps autograd's weight
gradient, as JAX's does). The dropout layers are numbered in module order
when the network is built, and ``forward(x, dropout_seed=s)`` keys each
layer's mask by ``(s, number)``.

``remat`` (``Networks.Remat``): every ``ConvBlock`` and
``DecoderConvBlock`` (the encoder levels, the bottom and the decoder
levels, packed or direct, 2D or 3D) is recomputed in the backward pass
(``layers.recomputed``), the boundaries of JAX's ``nn.remat``: the blocks
keep their inputs, not their activations. Same parameters and buffers,
same outputs, gradients, masks and running averages; in eval mode, under
``inference_mode`` and in ``torch.export`` the network is the plain one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.s2d import (depth_to_space, norm_factors, prod_factors,
                       space_to_depth)
from ..parallel.spatial import current_partition
from .layers import (Activation, DownConv, Dropout, Norm, SpatialConv,
                     TiledInputBatchNorm, UpConv, recomputed)

# the channels-last memory format of the network's tensors, by spatial rank
_MEMORY_FORMAT = {2: torch.channels_last, 3: torch.channels_last_3d}
CONV_IMPLS = ("direct", "s2d", "auto", "packed")


def adaptive_factors(spatial, ch, target_lanes):
    """Per-axis space-to-depth factors of a level: pack just enough axes
    (factor 2) that ``2^n * ch >= target_lanes``, chosen among the even
    extents, leading first. Returns ``(ok, factors)``, ``(False, None)``
    where no packing applies (``vnet_tpu/models/vnet.py:40-58``)."""
    rank = len(spatial)
    n = 0
    while n < rank and (2 ** n) * ch < target_lanes:
        n += 1
    even_axes = [i for i, s in enumerate(spatial) if s % 2 == 0]
    if n < 1 or len(even_axes) < n:
        return False, None
    chosen = set(even_axes[:n])
    return True, tuple(2 if i in chosen else 1 for i in range(rank))


class ConvBlock(nn.Module):
    """n x [5^rank conv -> (legacy: pre_norm) -> (+ block input at the last
    conv) -> norm -> act -> dropout]; children ``conv_i``, ``pre_norm_i``,
    ``norm_i``, ``act_i``, ``dropout_i``. ``impl`` is the convolutions'
    when the block runs unpacked."""

    def __init__(self, num_convolutions: int, channels: int,
                 norm: str = "batch", activation: str = "prelu",
                 dropout_rate: float = 0.0,
                 in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla", dw_impl: str = "xla",
                 rank: int = 3, impl: str = "direct",
                 legacy_double_norm: bool = False):
        super().__init__()
        self.num_convolutions = num_convolutions
        for i in range(num_convolutions):
            cin = (in_channels or channels) if i == 0 else channels
            self.add_module(f"conv_{i + 1}", SpatialConv(
                cin, channels, (5,) * rank, generator=generator,
                dw_impl=dw_impl, impl=impl))
            if self._pre_norm(i, legacy_double_norm):
                self.add_module(f"pre_norm_{i + 1}", Norm(norm, channels))
            self.add_module(f"norm_{i + 1}", Norm(norm, channels))
            self.add_module(f"act_{i + 1}", Activation(activation, channels))
            self.add_module(f"dropout_{i + 1}", Dropout(dropout_rate,
                                                        dropout_impl))

    def _pre_norm(self, i: int, legacy: bool) -> bool:
        return legacy

    def _layer(self, x, i, residual, factors=None, splits=None):
        groups = 1 if factors is None else prod_factors(factors)
        conv = getattr(self, f"conv_{i + 1}")
        if factors is None:
            x = conv(x)
        else:
            x = conv(x, packed=True, packed_factors=factors,
                     packed_input_splits=splits)
        pre = getattr(self, f"pre_norm_{i + 1}", None)
        if pre is not None:
            x = pre(x, groups)
        if i == self.num_convolutions - 1:
            x = x + residual
        x = getattr(self, f"norm_{i + 1}")(x, groups,
                                           act=getattr(self, f"act_{i + 1}"))
        return getattr(self, f"dropout_{i + 1}")(x)

    def forward(self, x, packed_factors=None, pack_input: bool = True,
                unpack_output: bool = True):
        """Unpacked with ``packed_factors=None``; else in the packed domain
        of those explicit factors, ``x`` packed here unless ``pack_input``
        is false, the output unpacked unless ``unpack_output`` is false."""
        if packed_factors is not None and pack_input:
            x = space_to_depth(x, factors=packed_factors)
        block_input = x
        for i in range(self.num_convolutions):
            x = self._layer(x, i, block_input, packed_factors)
        if packed_factors is not None and unpack_output:
            x = depth_to_space(x, factors=packed_factors)
        return x


class DecoderConvBlock(ConvBlock):
    """Concat the skip, then 5^rank convs 2n -> n, residual from the
    up-convolved input ``x``. Legacy double norm on every conv but the
    first of a multi-conv block."""

    def __init__(self, num_convolutions: int, channels: int, **kw):
        super().__init__(num_convolutions, channels,
                         in_channels=2 * channels, **kw)

    def _pre_norm(self, i: int, legacy: bool) -> bool:
        return legacy and (i > 0 or self.num_convolutions == 1)

    def forward(self, x, skip, packed_mode: bool = False,
                skip_packed: bool = False, x_packed: bool = False,
                unpack_output: bool = True, packed_factors=None):
        """``packed_mode``: run packed in ``packed_factors`` (explicit),
        splicing the skip as a flat packed concat; ``skip_packed`` /
        ``x_packed``: that input arrives packed (unpacked here in an
        unpacked block)."""
        if packed_mode:
            f = packed_factors
            groups = prod_factors(f)
            ch = x.shape[1] // groups if x_packed else x.shape[1]
            xp_x = x if x_packed else space_to_depth(x, factors=f)
            skip_p = skip if skip_packed else space_to_depth(skip, factors=f)
            x = torch.cat([xp_x, skip_p], dim=1)
            for i in range(self.num_convolutions):
                x = self._layer(x, i, xp_x, f, (ch, ch) if i == 0 else None)
            return depth_to_space(x, factors=f) if unpack_output else x
        if skip_packed:
            skip = depth_to_space(skip, factors=packed_factors)
        if x_packed:
            x = depth_to_space(x, factors=packed_factors)
        residual = x
        x = torch.cat([x, skip], dim=1)
        for i in range(self.num_convolutions):
            x = self._layer(x, i, residual)
        return x


class VNet(nn.Module):
    """V-Net (https://arxiv.org/abs/1606.04797), 2D or 3D.

    ``forward`` takes ``(B, *spatial, C_in)`` and returns float32 logits
    ``(B, *spatial, num_classes)``, the JAX layout, with ``spatial_rank``
    (2 or 3) spatial axes. Whether batch norms use
    running averages or batch statistics follows ``norm`` and the module's
    train/eval mode (``Norm``). In training mode with dropout,
    ``dropout_seed`` (an int, the step's seed) is required. ``conv_impl``,
    ``packed_cap``, ``packed_target_lanes``, ``legacy_double_norm`` and
    ``remat`` as in JAX's ``VNet`` (module docstring); the class defaults
    are JAX's class defaults, ``build_network``'s are the trainer's.
    """

    def __init__(self, num_classes: int, in_channels: int = 1,
                 num_channels: int = 16, num_levels: int = 4,
                 num_convolutions: Sequence[int] = (1, 2, 3, 3),
                 bottom_convolutions: int = 3, dropout_rate: float = 0.01,
                 activation: str = "prelu", norm: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_impl: str = "xla", dw_impl: str = "xla",
                 spatial_rank: int = 3, conv_impl: str = "direct",
                 packed_cap: int = 1024, packed_target_lanes: int = 0,
                 legacy_double_norm: bool = False, remat: bool = False):
        super().__init__()
        if num_levels != len(num_convolutions):
            raise ValueError("num_convolutions must have num_levels entries")
        if spatial_rank not in _MEMORY_FORMAT:
            raise ValueError(f"spatial_rank must be 2 or 3, got "
                             f"{spatial_rank}")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"Unknown conv_impl {conv_impl!r}; expected one "
                             f"of {CONV_IMPLS}")
        self.spatial_rank = rank = spatial_rank
        self.num_levels = num_levels
        self.dtype = dtype
        self.num_channels = num_channels
        self.norm = norm
        self.conv_impl = conv_impl
        self.packed_cap = packed_cap
        self.packed_target_lanes = packed_target_lanes
        self.remat = remat
        # vnet_tpu/models/vnet.py:305-311
        self.block_impl = "auto" if conv_impl == "s2d" else conv_impl
        impl = "auto" if self.block_impl in ("packed", "auto") else "direct"
        fallback = "direct" if packed_target_lanes > 0 else self.block_impl
        # an unpacked block's convs: "packed" means per-site "auto" there
        block_conv = "auto" if fallback == "packed" else fallback
        g = generator
        ch = num_channels

        self.tile_input = in_channels == 1
        if self.tile_input:
            self.input_norm = (TiledInputBatchNorm(ch, norm)
                               if norm in ("batch", "batch_stats")
                               else Norm(norm, ch))
        else:
            self.input_conv = SpatialConv(in_channels, ch, (5,) * rank,
                                          generator=g, dw_impl=dw_impl,
                                          impl=impl)
            self.input_norm = Norm(norm, ch)
            self.input_act = Activation(activation, ch)

        block_kw = dict(norm=norm, activation=activation,
                        dropout_rate=dropout_rate, generator=g,
                        dropout_impl=dropout_impl, dw_impl=dw_impl,
                        rank=rank, impl=block_conv,
                        legacy_double_norm=legacy_double_norm)
        for level in range(num_levels):
            self.add_module(f"encoder_level_{level + 1}", ConvBlock(
                num_convolutions[level], ch, **block_kw))
            self.add_module(f"down_{level + 1}", DownConv(
                ch, 2, norm, activation, generator=g, rank=rank, impl=impl))
            ch *= 2
        self.bottom = ConvBlock(bottom_convolutions, ch, **block_kw)
        for level in reversed(range(num_levels)):
            self.add_module(f"up_{level + 1}", UpConv(
                ch, 2, norm, activation, generator=g, rank=rank, impl=impl))
            ch //= 2
            self.add_module(f"decoder_level_{level + 1}", DecoderConvBlock(
                num_convolutions[level], ch, **block_kw))
        self.output_conv = SpatialConv(ch, num_classes, (1,) * rank,
                                       generator=g, dw_impl=dw_impl)
        self.output_norm = Norm(norm, num_classes)
        self.dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for index, m in enumerate(self.dropouts):
            m.index = index

    def level_packed(self, spatial, ch, decoder: bool = False):
        """``(packed?, factors)`` of a level of extents ``spatial`` and
        ``ch`` channels (a decoder level: its up-convolution's output),
        the factors explicit (``vnet_tpu/models/vnet.py:342-353``)."""
        if (self.block_impl != "packed"
                or self.norm not in ("batch", "batch_stats")):
            return False, None
        rank = len(spatial)
        if self.packed_target_lanes > 0:
            return adaptive_factors(spatial, ch, self.packed_target_lanes)
        cap = 2 * self.packed_cap if decoder else self.packed_cap
        ok = (all(s % 2 == 0 for s in spatial)
              and 2 ** rank * (2 * ch if decoder else ch) <= cap)
        return ok, (norm_factors(None, rank) if ok else None)

    def plan(self, spatial) -> dict:
        """The packing of every level for an input of extents ``spatial``,
        as :meth:`forward` runs it: ``{"encoder": [...], "bottom": ...,
        "decoder": [...]}`` of ``(packed?, factors)`` (levels from 0 up; a
        decoder level decided on its up-convolution's output, JAX's
        ``vnet_tpu/models/vnet.py:397-402``)."""
        ch = self.num_channels
        spatial = tuple(spatial)
        enc = []
        for _ in range(self.num_levels):
            enc.append(self.level_packed(spatial, ch))
            spatial = tuple(-(-s // 2) for s in spatial)
            ch *= 2
        bottom = self.level_packed(spatial, ch)
        dec = []
        for _ in range(self.num_levels):
            spatial = tuple(2 * s for s in spatial)
            ch //= 2
            dec.append(self.level_packed(spatial, ch, decoder=True))
        return {"encoder": enc, "bottom": bottom, "decoder": dec[::-1]}

    def forward(self, x, dropout_seed: Optional[int] = None):
        for m in self.dropouts:
            m.seed = dropout_seed
        rank = self.spatial_rank
        # (B, *spatial, C) -> logical (B, C, *spatial), channels-last memory
        x = x.to(self.dtype).permute(0, rank + 1, *range(1, rank + 1))
        if self.tile_input and isinstance(self.input_norm,
                                          TiledInputBatchNorm):
            x = self.input_norm(x)
        elif self.tile_input:
            x = self.input_norm(x.expand(-1, self.num_channels,
                                         *(-1,) * rank))
        else:
            x = self.input_norm(self.input_conv(x), act=self.input_act)
        x = x.contiguous(memory_format=_MEMORY_FORMAT[rank])

        # GSPMD (the trainer's partition) plans the unsharded program,
        # shard_map (spatial_sharded_*) the local one
        part = current_partition()
        plan = self.plan(part.global_extents(x.shape[2:])
                         if part is not None and part.global_plan
                         else x.shape[2:])
        skips = []
        for level, (enc_p, enc_f) in enumerate(plan["encoder"]):
            # recomputed under remat: vnet_tpu/models/vnet.py:285-298
            x = recomputed(getattr(self, f"encoder_level_{level + 1}"), x,
                           enc_f if enc_p else None, unpack_output=not enc_p,
                           enabled=self.remat)
            skips.append(x)
            x = getattr(self, f"down_{level + 1}")(
                x, packed_input=enc_p, packed_factors=enc_f)
        bot_p, bot_f = plan["bottom"]
        x = recomputed(self.bottom, x, bot_f if bot_p else None,
                       enabled=self.remat)

        for level in reversed(range(self.num_levels)):
            dec_p, dec_f = plan["decoder"][level]
            skip_p, skip_f = plan["encoder"][level]
            if skip_p and dec_p and skip_f != dec_f:
                raise AssertionError((skip_f, dec_f))
            x = getattr(self, f"up_{level + 1}")(
                x, packed_output=dec_p, packed_factors=dec_f)
            x = recomputed(
                getattr(self, f"decoder_level_{level + 1}"), x, skips[level],
                packed_mode=dec_p, skip_packed=skip_p,
                x_packed=dec_p, unpack_output=not (dec_p and level == 0),
                packed_factors=dec_f if dec_p else skip_f,
                enabled=self.remat)

        # a packed last decoder level feeds the output conv and norm packed
        out_packed, out_factors = plan["decoder"][0]
        groups = prod_factors(out_factors) if out_packed else 1
        logits = self.output_conv(x, packed=out_packed,
                                  packed_factors=out_factors)
        logits = self.output_norm(logits, groups)
        if out_packed:
            logits = depth_to_space(logits, factors=out_factors)
        return logits.float().permute(0, *range(2, rank + 2), 1)
