"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; Tang et al.,
arXiv:2111.14791) as MONAI's ``monai.networks.nets.SwinUNETR`` computes
it, 3D, with ``normalize`` on and every drop rate 0.

A Swin transformer encoder (``swinViT``): a ``PATCH``^3 stride-``PATCH``
convolution embeds the volume (no norm after it); four stages of
``DEPTHS[s]`` blocks with ``HEADS[s]`` heads of width 16 each end in a
patch merging that halves the grid and doubles the channels. A block is
``x + attn(LN1(x))`` then ``x + MLP(LN2(x))`` (LayerNorm eps 1e-5, MLP
ratio 4 with exact GELU). The attention zero-pads the normalised tokens at
the end of each axis to a multiple of the window, rolls them by minus half
the window on odd blocks, attends within each window
(``ops/window_attention.py``: relative-position bias, and for a shifted
block -100 between tokens of ``compute_mask``'s different regions; the
padded tokens are keys, unmasked, as in MONAI), rolls back and crops. Where
an axis of the grid is no longer than the window, the window is clamped to
it and that axis is not shifted; the bias index is then the 7^3
window's sliced to ``[:N, :N]`` (MONAI's), not the clamped window's own.
Patch merging concatenates each 2^3 cell's neighbours in
``itertools.product(range(2), repeat=3)`` order (MONAI's
``PatchMergingV2``, the Swin paper's; MONAI's older ``PatchMerging`` orders
them otherwise for old checkpoints), then ``LN(8C)`` and a linear map to
``2C`` without a bias. The five hidden states (the embedding and each
stage's merged output) are layer-normed over channels without affine
parameters.

A CNN decoder (MONAI's ``UnetrBasicBlock``/``UnetrUpBlock``/
``UnetOutBlock``): residual blocks of conv 3^3, instance norm, leaky ReLU
0.01, conv 3^3, instance norm, plus the input (through a 1^3 conv and an
instance norm where the channels change), then a leaky ReLU; convolutions
without bias; instance norm without affine parameters, eps 1e-5
(``nn.InstanceNorm3d``'s defaults; :func:`instance_norm`). ``encoder1``
reads the volume, ``encoder2``-``4`` hidden states 0-2, ``encoder10``
hidden state 4; up blocks (a stride-2 transpose convolution without bias,
the skip concatenated after it, a residual block of ``2 out -> out``) go
from ``16 f`` channels down to ``f``; a 1^3 convolution with a bias gives
the logits.

Parameter names are MONAI's ``state_dict`` keys
(``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``encoder1.layer.conv1.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.weight``, ...); convolution kernels in PyTorch's layout;
``relative_position_index`` is a non-persistent buffer, so the state dict
holds the learned leaves alone. Parameters stay float32 and are cast to the
compute dtype at use. Tensors are channels-last as in the other networks:
forward takes and returns ``(B, X, Y, Z, C)``; the encoder works on tokens
``(B, X, Y, Z, C)``.

``remat`` (``Networks.Remat``, MONAI's ``use_checkpoint``) recomputes
each Swin block in the backward pass (``layers.recomputed``). Spans:
``vnet.swin.encoder`` around the encoder, ``vnet.unetr.decoder`` around
the CNN blocks and the head, ``vnet.swin.window_attention`` around each
attention call.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attention import window_attention
from ..profiler import span
from .layers import SpatialConv, SpatialConvTranspose, recomputed

LN_EPS = 1e-5
IN_EPS = 1e-5
LEAKY_SLOPE = 0.01
MLP_RATIO = 4
# MONAI's SwinUNETR defaults, the published settings: every shipped config
# uses them, so ``Networks`` has no keys for them
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
WINDOW = (7, 7, 7)
PATCH = 2


# ---------------------------------------------------------------- windows
def window_for(grid: Sequence[int], window: Sequence[int],
               shift: Sequence[int]) -> Tuple[tuple, tuple]:
    """MONAI's ``get_window_size``: the window and shift on a ``grid``,
    each axis no longer than the window clamped to it and not shifted."""
    ws, ss = list(window), list(shift)
    for a, n in enumerate(grid):
        if n <= window[a]:
            ws[a], ss[a] = n, 0
    return tuple(ws), tuple(ss)


def relative_position_index(window: Sequence[int]) -> torch.Tensor:
    """``(N, N)`` int64 index into the ``prod(2w - 1)`` bias table: the
    coordinate differences of two tokens of the window, shifted by ``w -
    1`` and mixed with strides ``(2w1-1)(2w2-1)``, ``2w2-1``, 1."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    strides = torch.tensor([(2 * window[1] - 1) * (2 * window[2] - 1),
                            2 * window[2] - 1, 1])
    return (rel * strides).sum(-1)


def partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """``(B, D, H, W, C)`` (multiples of the window) to ``(B * nW, N, C)``,
    windows in raster order (MONAI's ``window_partition``)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), c)


def reverse(windows: torch.Tensor, ws: Sequence[int], b: int,
            grid: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition`: ``(B, D, H, W, C)``."""
    d, h, w = grid
    c = windows.shape[-1]
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


@functools.lru_cache(maxsize=32)
def _regions(grid: tuple, ws: tuple, ss: tuple) -> torch.Tensor:
    img = torch.zeros((1, *grid, 1), dtype=torch.int32)
    cnt = 0
    slices = [(slice(-w), slice(-w, -s), slice(-s, None))
              for w, s in zip(ws, ss)]
    for sd, sh, sw in itertools.product(*slices):
        img[:, sd, sh, sw, :] = cnt
        cnt += 1
    return partition(img, ws).squeeze(-1).contiguous()


def region_ids(grid: Sequence[int], ws: Sequence[int], ss: Sequence[int],
               device) -> torch.Tensor:
    """``(nW, N)`` int32: the region of MONAI's ``compute_mask`` slices
    ``(0:-w), (-w:-s), (-s:)`` on each axis of the padded ``grid`` that each
    token of each window comes from."""
    return _regions(tuple(grid), tuple(ws), tuple(ss)).to(device)


# ------------------------------------------------------------------ norms
def layer_norm(x: torch.Tensor, norm: Optional[nn.LayerNorm]) -> torch.Tensor:
    """LayerNorm over the last axis in ``x``'s dtype (``norm``'s float32
    affine cast to it), eps 1e-5; without affine parameters for ``None``."""
    if norm is None:
        return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), LN_EPS)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


class _InstanceNorm(torch.autograd.Function):
    """Instance norm (no affine, eps 1e-5) and an optional leaky ReLU of
    ``x`` ``(B, S, C)`` over ``S``, statistics and arithmetic in float32,
    rounded once to ``x``'s dtype. Saves ``x`` and the per-sample
    ``(mean, rstd)`` alone: the backward's closed form
    ``dx = rstd * (dz - mean(dz) - xhat * mean(dz * xhat))`` recomputes
    ``xhat``."""

    @staticmethod
    def forward(ctx, x, slope):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=1, keepdim=True, unbiased=False)
        rstd = torch.rsqrt(var + IN_EPS)
        z = (xf - mean) * rstd
        if slope is not None:
            z = F.leaky_relu(z, slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.slope = slope
        return z.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd = ctx.saved_tensors
        xhat = (x.float() - mean) * rstd
        dz = dy.float()
        if ctx.slope is not None:
            dz = torch.where(xhat > 0, dz, dz * ctx.slope)
        dx = rstd * (dz - dz.mean(1, keepdim=True)
                     - xhat * (dz * xhat).mean(1, keepdim=True))
        return dx.to(x.dtype), None


def instance_norm(x: torch.Tensor, slope: Optional[float] = None):
    """``nn.InstanceNorm3d`` (no affine, eps 1e-5) of ``x`` ``(B, C, *s)``
    (channels-last), then ``leaky_relu(., slope)`` unless ``slope`` is
    ``None``; channels-last out."""
    b, c = x.shape[:2]
    rows = x.movedim(1, -1)
    y = _InstanceNorm.apply(rows.reshape(b, -1, c), slope)
    return y.view(rows.shape).movedim(-1, 1)


def _trunc_normal_(t: torch.Tensor, generator) -> None:
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                              generator=generator)


def _linear(cin: int, cout: int, bias: bool, generator) -> nn.Linear:
    layer = nn.Linear(cin, cout, bias=bias)
    _trunc_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


# ------------------------------------------------------------ Swin encoder
class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, generator):
        super().__init__()
        self.proj = SpatialConv(in_channels, dim, (patch,) * 3, (patch,) * 3,
                                generator=generator)

    def forward(self, x):
        return self.proj(x)


class WindowAttention(nn.Module):
    """The relative-position bias table, its index (a non-persistent
    buffer of the configured window), the qkv and output projections."""

    def __init__(self, dim: int, heads: int, window: Sequence[int],
                 generator):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), heads))
        _trunc_normal_(self.relative_position_bias_table, generator)
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)
        self.qkv = _linear(dim, 3 * dim, True, generator)
        self.proj = _linear(dim, dim, True, generator)

    def forward(self, windows, regions):
        n = windows.shape[1]
        qkv = linear(windows, self.qkv)
        index = self.relative_position_index[:n, :n]
        out = window_attention(qkv, self.heads,
                               self.relative_position_bias_table, index,
                               regions, self.scale)
        return linear(out, self.proj)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, generator):
        super().__init__()
        self.linear1 = _linear(dim, hidden, True, generator)
        self.linear2 = _linear(hidden, dim, True, generator)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.linear1)), self.linear2)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: Sequence[int],
                 generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window, generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, MLP_RATIO * dim, generator)

    def forward(self, x, ws, ss, regions):
        b, d, h, w, _ = x.shape
        y = layer_norm(x, self.norm1)
        pads = [(-n) % k for n, k in zip((d, h, w), ws)]
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        grid = tuple(y.shape[1:4])
        shifted = any(s > 0 for s in ss)
        if shifted:
            y = torch.roll(y, tuple(-s for s in ss), (1, 2, 3))
        y = self.attn(partition(y, ws), regions if shifted else None)
        y = reverse(y, ws, b, grid)
        if shifted:
            y = torch.roll(y, tuple(ss), (1, 2, 3))
        if any(pads):
            y = y[:, :d, :h, :w].contiguous()
        x = x + y
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchMerging(nn.Module):
    """MONAI's ``PatchMergingV2``: the 2^3 neighbours concatenated in
    ``itertools.product(range(2), repeat=3)`` order, ``LN(8C)``, a linear
    map to ``2C`` without a bias."""

    def __init__(self, dim: int, generator):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = _linear(8 * dim, 2 * dim, False, generator)

    def forward(self, x):
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2]
                       for i, j, k in itertools.product(range(2), repeat=3)],
                      dim=-1)
        return linear(layer_norm(x, self.norm), self.reduction)


class BasicLayer(nn.Module):
    """One stage: its blocks (even ones unshifted, odd ones shifted by half
    the window) and the merge."""

    def __init__(self, dim: int, depth: int, heads: int,
                 window: Sequence[int], generator, remat: bool):
        super().__init__()
        self.window = tuple(window)
        self.shift = tuple(w // 2 for w in window)
        self.remat = remat
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, generator)
            for _ in range(depth))
        self.downsample = PatchMerging(dim, generator)

    def forward(self, x):
        grid = tuple(x.shape[1:4])
        ws, ss = window_for(grid, self.window, self.shift)
        padded = tuple(-(-n // k) * k for n, k in zip(grid, ws))
        shifted = any(s > 0 for s in ss)
        regions = (region_ids(padded, ws, ss, x.device) if shifted
                   else None)
        no_shift = (0, 0, 0)
        for i, blk in enumerate(self.blocks):
            x = recomputed(blk, x, ws, ss if i % 2 else no_shift, regions,
                           enabled=self.remat)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    def __init__(self, in_channels: int, dim: int, depths, heads, window,
                 patch: int, generator, remat: bool):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim, patch, generator)
        for s, (depth, nh) in enumerate(zip(depths, heads)):
            setattr(self, f"layers{s + 1}", nn.ModuleList([BasicLayer(
                dim * 2 ** s, depth, nh, window, generator, remat)]))
        self.num_stages = len(depths)

    def forward(self, x):
        """The hidden states of ``x`` ``(B, C, D, H, W)`` (channels-last),
        each ``(B, C_s, D_s, H_s, W_s)`` channels-last, layer-normed over
        channels."""
        t = self.patch_embed(x).permute(0, 2, 3, 4, 1).contiguous()
        states = [t]
        for s in range(self.num_stages):
            t = getattr(self, f"layers{s + 1}")[0](t)
            states.append(t)
        return [layer_norm(t, None).permute(0, 4, 1, 2, 3) for t in states]


# -------------------------------------------------------------- CNN blocks
class _Conv(nn.Module):
    """MONAI's ``Convolution`` holder: the kernel is its ``conv`` child."""

    def __init__(self, cin: int, cout: int, kernel: int, generator,
                 bias: bool = False, transpose: bool = False):
        super().__init__()
        if transpose:
            self.conv = SpatialConvTranspose(cin, cout, (kernel,) * 3,
                                             (kernel,) * 3,
                                             generator=generator, bias=bias)
        else:
            self.conv = SpatialConv(cin, cout, (kernel,) * 3,
                                    generator=generator, bias=bias)

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 3, generator)
        self.conv2 = _Conv(cout, cout, 3, generator)
        self.conv3 = (_Conv(cin, cout, 1, generator) if cin != cout
                      else None)

    def forward(self, x):
        y = instance_norm(self.conv1(x), LEAKY_SLOPE)
        y = instance_norm(self.conv2(y))
        res = x if self.conv3 is None else instance_norm(self.conv3(x))
        return F.leaky_relu(y + res, LEAKY_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.layer = UnetResBlock(cin, cout, generator)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.transp_conv = _Conv(cin, cout, 2, generator, transpose=True)
        self.conv_block = UnetResBlock(2 * cout, cout, generator)

    def forward(self, x, skip):
        up = self.transp_conv(x)
        return self.conv_block(torch.cat([up, skip], dim=1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.conv = _Conv(cin, cout, 1, generator, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinUNETR(nn.Module):
    """``forward(x, dropout_seed=None)``: logits ``(B, X, Y, Z, classes)``
    float32 of ``x`` ``(B, X, Y, Z, C)``, every extent a multiple of
    ``PATCH * 2^stages`` (32; MONAI's check).
    ``dropout_seed`` is taken for the trainer's interface and unused: every
    drop rate is 0."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 feature_size: int = 48, dtype: torch.dtype = torch.float32,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = int(feature_size)
        if f % HEADS[0]:
            raise ValueError(f"feature size {f} does not split over "
                             f"{HEADS[0]} heads")
        self.dtype = dtype
        self.remat = bool(remat)
        self.num_levels = len(DEPTHS)
        self.multiple = PATCH * 2 ** len(DEPTHS)
        g = generator
        self.swinViT = SwinTransformer(in_channels, f, DEPTHS, HEADS, WINDOW,
                                       PATCH, g, self.remat)
        self.encoder1 = UnetrBasicBlock(in_channels, f, g)
        self.encoder2 = UnetrBasicBlock(f, f, g)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f, g)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f, g)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f, g)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, g)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, g)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, g)
        self.decoder2 = UnetrUpBlock(2 * f, f, g)
        self.decoder1 = UnetrUpBlock(f, f, g)
        self.out = UnetOutBlock(f, num_classes, g)

    def forward(self, x, dropout_seed: Optional[int] = None):
        if any(n % self.multiple for n in x.shape[1:4]):
            raise ValueError(f"SwinUNETR needs extents divisible by "
                             f"{self.multiple}, got {tuple(x.shape[1:4])}")
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)
        with span("vnet.swin.encoder"):
            hidden = self.swinViT(x)
        with span("vnet.unetr.decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            dec4 = self.encoder10(hidden[4])
            dec3 = self.decoder5(dec4, hidden[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            out = self.decoder1(dec0, enc0)
            logits = self.out(out)
        return logits.float().permute(0, 2, 3, 4, 1)
