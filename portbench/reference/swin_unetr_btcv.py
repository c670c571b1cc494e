"""Plain PyTorch reference of ``swin_unetr_btcv``: Swin UNETR as MONAI's
``monai.networks.nets.SwinUNETR`` computes it (feature 48, depths (2, 2,
2, 2), heads (3, 6, 12, 24), window 7^3, patch 2, ``normalize``, drop
rates 0, PatchMergingV2's neighbour order), the mixed Sørensen loss and
Adam (``vnet3d_liver.train``).

The equations, each written out here again (nothing of the port):

* patch embedding: a 2^3 stride-2 convolution with a bias, no norm;
* a Swin block: ``x + attn(LN1(x))``, then ``x + MLP(LN2(x))`` (LayerNorm
  eps 1e-5, MLP 4x with exact GELU). The attention zero-pads the normalised
  tokens at the end of each axis to a multiple of the window, rolls odd
  blocks by minus half the window, partitions into windows, ``qkv`` a
  linear map with a bias, ``q`` scaled by ``16^-0.5``, the scores ``q
  k^T`` plus the relative-position bias plus, on shifted blocks, -100
  between tokens of different regions of ``compute_mask``'s slices, the
  softmax, ``@ v``, ``proj``; then the windows reversed, rolled back and
  cropped. The padded tokens are keys, unmasked. Where an axis of the grid
  is no longer than the window the window is clamped to it and not shifted,
  and the bias index is the 7^3 window's sliced to ``[:N, :N]`` (MONAI's);
* patch merging: the 2^3 neighbours concatenated in
  ``itertools.product(range(2), repeat=3)`` order, ``LN(8C)``, a linear
  map to ``2C`` without a bias; hidden states layer-normed without affine;
* the CNN part: residual blocks of conv 3^3, instance norm (no affine, eps
  1e-5), leaky ReLU 0.01, conv 3^3, instance norm, the input added (through
  a 1^3 conv and an instance norm where the channels change), leaky ReLU;
  no convolution biases; up blocks of a stride-2 transpose convolution, the
  skip concatenated after it and a residual block; a 1^3 head with a bias.

Float32 with TF32 off, or, for the control, every activation and weight
rounded to fp8 (``vnet3d_liver.rounding``). Tensors are ``(B, C, X, Y, Z)``
in the CNN part and ``(B, X, Y, Z, C)`` tokens in the encoder. The scores
are computed explicitly, windows in chunks of ``WINDOW_CHUNK``; in
training each Swin block, each chunk, each merge and each CNN block runs
under ``torch.utils.checkpoint`` so that a batch of 8 96^3 patches fits.
Parameters are a dict keyed by MONAI's ``state_dict`` names.

Depths, heads, window and patch are MONAI's defaults, the published
settings (``DEPTHS``, ``HEADS``, ``WINDOW``, ``PATCH``); the patch shape
and ``Remat`` of the counts are read from this configuration's frozen file,
``configs/swin_unetr_btcv.json``.
"""

from __future__ import annotations

import itertools
import math
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import spec
from portbench.reference import vnet3d_liver as base
from portbench.reference.vnet3d_liver import Ctx, run
from portbench.yardstick import flops

CONFIG = spec.ROOT / "configs" / "swin_unetr_btcv.json"
LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
MASK = -100.0
WINDOW_CHUNK = 256
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
WINDOW = (7, 7, 7)
PATCH = 2
strict_float32 = base.strict_float32
train = base.train
params_only = base.params_only


def frozen_settings() -> dict:
    """``{"patch_shape", "remat"}`` from the frozen configuration."""
    ts = spec.load_json(CONFIG)["settings"]["TrainingSetting"]
    return {"patch_shape": [int(n) for n in ts["PatchShape"]],
            "remat": bool(ts["Networks"].get("Remat", False))}


# ------------------------------------------------------------- parameters
def _resblock_shapes(name: str, cin: int, cout: int):
    out = [(f"{name}.conv1.conv.weight", (cout, cin, 3, 3, 3)),
           (f"{name}.conv2.conv.weight", (cout, cout, 3, 3, 3))]
    if cin != cout:
        out.append((f"{name}.conv3.conv.weight", (cout, cin, 1, 1, 1)))
    return out


def named_shapes(net: dict) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every parameter (MONAI's names)."""
    f, cin = int(net["num_channel"]), int(net["in_channels"])
    p = PATCH
    table = math.prod(2 * w - 1 for w in WINDOW)
    out = [("swinViT.patch_embed.proj.weight", (f, cin, p, p, p)),
           ("swinViT.patch_embed.proj.bias", (f,))]
    for s, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        dim = f * 2 ** s
        for b in range(depth):
            pre = f"swinViT.layers{s + 1}.0.blocks.{b}."
            out += [(pre + "norm1.weight", (dim,)), (pre + "norm1.bias", (dim,)),
                    (pre + "attn.relative_position_bias_table",
                     (table, heads)),
                    (pre + "attn.qkv.weight", (3 * dim, dim)),
                    (pre + "attn.qkv.bias", (3 * dim,)),
                    (pre + "attn.proj.weight", (dim, dim)),
                    (pre + "attn.proj.bias", (dim,)),
                    (pre + "norm2.weight", (dim,)), (pre + "norm2.bias", (dim,)),
                    (pre + "mlp.linear1.weight", (4 * dim, dim)),
                    (pre + "mlp.linear1.bias", (4 * dim,)),
                    (pre + "mlp.linear2.weight", (dim, 4 * dim)),
                    (pre + "mlp.linear2.bias", (dim,))]
        pre = f"swinViT.layers{s + 1}.0.downsample."
        out += [(pre + "norm.weight", (8 * dim,)),
                (pre + "norm.bias", (8 * dim,)),
                (pre + "reduction.weight", (2 * dim, 8 * dim))]
    for name, a, b in (("encoder1", cin, f), ("encoder2", f, f),
                       ("encoder3", 2 * f, 2 * f), ("encoder4", 4 * f, 4 * f),
                       ("encoder10", 16 * f, 16 * f)):
        out += _resblock_shapes(name + ".layer", a, b)
    for name, a, b in _ups(f):
        out.append((f"{name}.transp_conv.conv.weight", (a, b, 2, 2, 2)))
        out += _resblock_shapes(name + ".conv_block", 2 * b, b)
    classes = int(net["num_classes"])
    out += [("out.conv.conv.weight", (classes, f, 1, 1, 1)),
            ("out.conv.conv.bias", (classes,))]
    return out


def _ups(f: int):
    return (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
            ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f),
            ("decoder1", f, f))


# ----------------------------------------------------------------- windows
def clamped(grid, window, shift):
    """MONAI's ``get_window_size``."""
    ws, ss = list(window), list(shift)
    for a in range(3):
        if grid[a] <= window[a]:
            ws[a], ss[a] = grid[a], 0
    return ws, ss


def bias_index(window) -> torch.Tensor:
    """The 3D relative-position index of the configured window, ``(N, N)``."""
    pts = list(itertools.product(*[range(w) for w in window]))
    c = torch.tensor(pts)
    d = c[:, None, :] - c[None, :, :] + torch.tensor(window) - 1
    return (d[..., 0] * (2 * window[1] - 1) * (2 * window[2] - 1)
            + d[..., 1] * (2 * window[2] - 1) + d[..., 2])


def to_windows(x: torch.Tensor, ws) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2],
                  c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), c)


def from_windows(x: torch.Tensor, ws, b, grid) -> torch.Tensor:
    d, h, w = grid
    x = x.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2],
                  -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(grid, ws, ss, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: ``(nW, N, N)``, -100 between tokens of
    different regions."""
    img = torch.zeros((1, *grid, 1))
    cnt = 0
    for sd in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for sh in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            for sw in (slice(-ws[2]), slice(-ws[2], -ss[2]),
                       slice(-ss[2], None)):
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    win = to_windows(img, ws).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return torch.where(diff != 0, MASK, 0.0).to(device)


# ------------------------------------------------------------------ layers
def _linear(ctx: Ctx, name: str, x, bias: bool = True):
    P, q = ctx.P, ctx.q
    b = P[name + ".bias"] if bias else None
    return q(F.linear(q(x), q(P[name + ".weight"]), b))


def _ln(ctx: Ctx, name: Optional[str], x):
    if name is None:
        return ctx.q(F.layer_norm(x, x.shape[-1:], eps=LN_EPS))
    return ctx.q(F.layer_norm(x, x.shape[-1:], ctx.P[name + ".weight"],
                              ctx.P[name + ".bias"], LN_EPS))


def _attend(ctx: Ctx, pre: str, qkv, heads: int, index, mask):
    """Attention of a chunk of windows ``(bw, N, 3C)``; ``mask`` ``(bw, N,
    N)`` or ``None``."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    qh, kh, vh = qkv.reshape(bw, n, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    s = (qh * (c // heads) ** -0.5) @ kh.transpose(-2, -1)
    table = ctx.P[pre + "attn.relative_position_bias_table"]
    s = s + table[index.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    if mask is not None:
        s = s + mask.unsqueeze(1)
    p = ctx.q(torch.softmax(s, dim=-1))
    return ctx.q((p @ vh).transpose(1, 2).reshape(bw, n, c))


def _block(ctx: Ctx, pre: str, x, heads: int, window, shifted: bool):
    b, d, h, w, c = x.shape
    ws, ss = clamped((d, h, w), window, [k // 2 for k in window])
    if not shifted:
        ss = [0, 0, 0]
    y = _ln(ctx, pre + "norm1", x)
    pads = [(-n) % k for n, k in zip((d, h, w), ws)]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    grid = y.shape[1:4]
    on = any(s > 0 for s in ss)
    if on:
        y = torch.roll(y, shifts=[-s for s in ss], dims=(1, 2, 3))
    win = to_windows(y, ws)
    n = win.shape[1]
    index = bias_index(window)[:n, :n].to(x.device)
    masks = shift_mask(grid, ws, ss, x.device) if on else None
    nw = math.prod(g // k for g, k in zip(grid, ws))
    qkv = _linear(ctx, pre + "attn.qkv", win)
    parts = []
    for lo in range(0, qkv.shape[0], WINDOW_CHUNK):
        chunk = qkv[lo:lo + WINDOW_CHUNK]
        m = None
        if masks is not None:
            ids = torch.arange(lo, lo + chunk.shape[0], device=x.device) % nw
            m = masks[ids]
        parts.append(run(ctx, _attend, pre, chunk, heads, index, m))
    y = _linear(ctx, pre + "attn.proj", torch.cat(parts))
    y = from_windows(y, ws, b, grid)
    if on:
        y = torch.roll(y, shifts=list(ss), dims=(1, 2, 3))
    x = x + y[:, :d, :h, :w]
    z = _ln(ctx, pre + "norm2", x)
    z = _linear(ctx, pre + "mlp.linear2",
                F.gelu(_linear(ctx, pre + "mlp.linear1", z)))
    return ctx.q(x + z)


def _merge(ctx: Ctx, pre: str, x):
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                   itertools.product(range(2), range(2), range(2))], -1)
    return _linear(ctx, pre + "reduction", _ln(ctx, pre + "norm", x),
                   bias=False)


def _embed(ctx: Ctx, x, patch: int):
    P, q = ctx.P, ctx.q
    pads = [(-n) % patch for n in x.shape[2:]]
    x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
    y = F.conv3d(q(x), q(P["swinViT.patch_embed.proj.weight"]),
                 P["swinViT.patch_embed.proj.bias"], stride=patch)
    return q(y.permute(0, 2, 3, 4, 1))


def encoder(ctx: Ctx, x) -> List[torch.Tensor]:
    """The five hidden states ``(B, C, D, H, W)`` of ``x`` ``(B, C, X, Y,
    Z)``."""
    t = run(ctx, _embed, x, PATCH)
    states = [t]
    for s, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        for blk in range(depth):
            t = run(ctx, _block, f"swinViT.layers{s + 1}.0.blocks.{blk}.", t,
                    heads, WINDOW, blk % 2 == 1)
        t = run(ctx, _merge, f"swinViT.layers{s + 1}.0.downsample.", t)
        states.append(t)
    return [_ln(ctx, None, t).permute(0, 4, 1, 2, 3) for t in states]


def _conv(ctx: Ctx, name: str, x):
    w = ctx.q(ctx.P[name + ".conv.weight"])
    return ctx.q(F.conv3d(ctx.q(x), w, None, padding=(w.shape[-1] - 1) // 2))


def _inorm(ctx: Ctx, x):
    var, mean = torch.var_mean(x, dim=(2, 3, 4), keepdim=True,
                               unbiased=False)
    return ctx.q((x - mean) * torch.rsqrt(var + IN_EPS))


def _resblock(ctx: Ctx, name: str, x):
    y = F.leaky_relu(_inorm(ctx, _conv(ctx, name + ".conv1", x)), SLOPE)
    y = _inorm(ctx, _conv(ctx, name + ".conv2", y))
    if name + ".conv3.conv.weight" in ctx.P:
        x = _inorm(ctx, _conv(ctx, name + ".conv3", x))
    return ctx.q(F.leaky_relu(y + x, SLOPE))


def _up(ctx: Ctx, name: str, x, skip):
    w = ctx.q(ctx.P[name + ".transp_conv.conv.weight"])
    up = ctx.q(F.conv_transpose3d(ctx.q(x), w, None, stride=2))
    return run(ctx, _resblock, name + ".conv_block",
               torch.cat([up, skip], dim=1))


def network(ctx: Ctx, net: dict, x):
    """Logits ``(B, X, Y, Z, classes)`` of ``x`` ``(B, X, Y, Z, C)``."""
    x = x.permute(0, 4, 1, 2, 3)
    hidden = encoder(ctx, x)
    enc0 = run(ctx, _resblock, "encoder1.layer", x)
    enc1 = run(ctx, _resblock, "encoder2.layer", hidden[0])
    enc2 = run(ctx, _resblock, "encoder3.layer", hidden[1])
    enc3 = run(ctx, _resblock, "encoder4.layer", hidden[2])
    dec = run(ctx, _resblock, "encoder10.layer", hidden[4])
    for name, skip in (("decoder5", hidden[3]), ("decoder4", enc3),
                       ("decoder3", enc2), ("decoder2", enc1),
                       ("decoder1", enc0)):
        dec = _up(ctx, name, dec, skip)
    w, b = ctx.P["out.conv.conv.weight"], ctx.P["out.conv.conv.bias"]
    logits = ctx.q(F.conv3d(ctx.q(dec), ctx.q(w), b))
    return logits.permute(0, 2, 3, 4, 1)


# -------------------------------------------------------------------- loss
def loss(logits, batch: dict, settings: dict):
    """``1 - dice + alpha * cross entropy`` (the mixed Sørensen, as
    ``attention3d_mm.loss`` computes it without the distance-map term)."""
    classes = int(settings["network"]["num_classes"])
    onehot = F.one_hot(batch["labels"].long(), classes).to(logits.dtype)
    xent = (-(onehot * F.log_softmax(logits, dim=-1)).sum(-1)).mean()
    return (base.dice_loss(logits, batch["labels"], classes)
            + settings["loss"]["alpha"] * xent)


def forward_loss(settings: dict):
    """The configuration's ``forward_loss`` for ``vnet3d_liver.train``."""
    net = settings["network"]

    def fn(P, batch, seed, q):
        ctx = Ctx(P, "train", q, ckpt=True)
        return loss(network(ctx, net, batch["images"]), batch, settings)
    return fn


# ------------------------------------------------------------ model FLOPs
def _grids(patch_shape):
    """Each stage's token grid."""
    g = [-(-n // PATCH) for n in patch_shape]
    out = []
    for _ in DEPTHS:
        out.append(g)
        g = [-(-n // 2) for n in g]
    return out


def flops_per_voxel(net: dict) -> Fraction:
    """Forward FLOPs per input voxel at the frozen patch shape
    (``yardstick.flops``' convention: ``2 k^3 Ci Co`` an output voxel of a
    convolution, ``2 Ci Co`` an output voxel of the stride-2 transpose
    convolutions and a token of a linear map; the window products ``4 N d``
    a padded token and head; no norms, activations, softmax or loss)."""
    shape = frozen_settings()["patch_shape"]
    vox = math.prod(shape)
    f, cin = int(net["num_channel"]), int(net["in_channels"])
    c = flops.conv
    total = Fraction(0)
    # the Swin encoder, counted over the stage grids
    total += Fraction(math.prod(_grids(shape)[0]) * 2 * PATCH ** 3 * cin * f,
                      vox)
    for s, (grid, depth, heads) in enumerate(zip(_grids(shape), DEPTHS,
                                                 HEADS)):
        dim = f * 2 ** s
        tokens = math.prod(grid)
        ws, _ = clamped(grid, WINDOW, [0, 0, 0])
        padded = math.prod(-(-g // k) * k for g, k in zip(grid, ws))
        n = math.prod(ws)
        per_token = 2 * dim * 3 * dim + 2 * dim * dim + 2 * 2 * dim * 4 * dim
        total += Fraction(depth * (tokens * per_token
                                   + padded * heads * 4 * n * (dim // heads)),
                          vox)
        merged = math.prod(-(-g // 2) for g in grid)
        total += Fraction(merged * 2 * 8 * dim * 2 * dim, vox)

    def res(a, b):
        return c(3, a, b) + c(3, b, b) + (c(1, a, b) if a != b else 0)

    total += res(cin, f)
    for scale, ch in ((8, f), (64, 2 * f), (512, 4 * f), (32768, 16 * f)):
        total += Fraction(res(ch, ch), scale)
    for (name, a, b), scale in zip(_ups(f), (4096, 512, 64, 8, 1)):
        total += Fraction(2 * a * b + res(2 * b, b), scale)
    total += c(1, f, int(net["num_classes"]))
    return total


# ------------------------------------------- the window attention's counts
def attention_calls(batch: int, net: dict
                    ) -> List[Tuple[int, int, int, int]]:
    """``(window rows, heads, N, head width)`` of each window-attention call
    of one forward pass at the frozen patch shape."""
    out = []
    for s, (grid, depth, heads) in enumerate(zip(
            _grids(frozen_settings()["patch_shape"]), DEPTHS, HEADS)):
        ws, _ = clamped(grid, WINDOW, [0, 0, 0])
        nw = math.prod(-(-g // k) for g, k in zip(grid, ws))
        width = int(net["num_channel"]) * 2 ** s // heads
        out += [(batch * nw, heads, math.prod(ws), width)] * depth
    return out


def attention_counts(bw: int, heads: int, n: int, head_width: int = 16
                     ) -> Dict[str, float]:
    """Operations and bytes of one window-attention call, each input byte
    read once and each output byte written once: forward ``4 N d``
    operations a query row and head (the two products), q, k, v read, O
    (bf16) and the log-sum-exp (float32) written; backward ``8 N d`` (dV,
    dP, dQ, dK, not the kernel's recompute of ``S``), q, k, v, O, dO and the
    log-sum-exp read, dq, dk, dv written."""
    rows = bw * heads * n
    tensor = rows * head_width * 2
    return {"fwd_flops": 4.0 * rows * n * head_width,
            "fwd_bytes": float(4 * tensor + 4 * rows),
            "bwd_flops": 8.0 * rows * n * head_width,
            "bwd_bytes": float(8 * tensor + 4 * rows)}


def attention_step(batch: int, net: dict) -> Dict[str, float]:
    """One training step's window-attention work: ``fwd_launches`` (each
    forward call, twice under ``Remat``: forward and recompute) and
    ``bound_s``, the sum over launches of the longer of operations at the
    bf16 peak and bytes at the HBM rate."""
    from portbench.yardstick.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

    passes = 2 if frozen_settings()["remat"] else 1
    calls = attention_calls(batch, net)
    bound = 0.0
    for bw, heads, n, width in calls:
        k = attention_counts(bw, heads, n, width)
        bound += passes * max(k["fwd_flops"] / BF16_FLOPS_PER_S,
                              k["fwd_bytes"] / HBM_BYTES_PER_S)
        bound += max(k["bwd_flops"] / BF16_FLOPS_PER_S,
                     k["bwd_bytes"] / HBM_BYTES_PER_S)
    return {"fwd_launches": passes * len(calls), "bound_s": bound}
