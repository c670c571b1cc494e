"""Plain PyTorch reference of ``vnet3d_liver``: the V-Net of
``configs/config.json`` (arXiv:1606.04797 as the TensorFlow project the
JAX package follows builds it), its weighted Sørensen loss, Adam and the
Gaussian-blended sliding-window evaluation.

Float32 with TF32 off (:func:`strict_float32`), or, for the control, every
activation, weight and gradient rounded to fp8 (``precision="fp8"``: e4m3
forward, e5m2 backward, each tensor scaled to its format's range). It
imports nothing of the port and takes only the benchmark's weights and
inputs; what the port derives from them (packed kernels, masks, running
averages) it works out again. Parameters are a dict keyed by the
configuration's module paths (``encoder_level_1.conv_1.weight``, ...).

The network (tensors ``(B, C, X, Y, Z)`` inside, the JAX layout ``(B, X,
Y, Z, C)`` at the ends): a one-channel input is normalised and tiled to
``num_channel`` channels (a multichannel one: 5^3 conv, norm, PReLU);
encoder level ``l`` runs ``num_convolutions[l]`` units of 5^3 conv (the
block input added at the last), batch norm, PReLU, dropout, then a
stride-2 2^3 conv doubling channels with norm and PReLU; the bottom runs
``bottom_convolutions`` units; decoder level ``l`` up-samples by a stride-2
2^3 transpose conv halving channels with norm and PReLU, concatenates the
skip and runs its units 2n -> n with the up-sampled features added at the
last; a 1^3 conv to the classes and a batch norm give the logits. Batch
norm: epsilon 1e-3, the biased variance (training here follows no
running average: no checked number reads one). Dropout keeps an
element iff its counter word (``yardstick.philox``) is below the
threshold and divides survivors by the keep probability; the layers are
numbered in module order. In training every unit runs under
``torch.utils.checkpoint`` so that the full batch fits.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.yardstick import flops, philox

EPS = 1e-3
SMOOTH = 1e-5
ADAM = (0.9, 0.999, 1e-8)


def strict_float32() -> None:
    """Float32 products and convolutions without TF32 (cuDNN's default
    choice of algorithm: its autotuning costs minutes a process here)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- precision
def _scaled_round(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = fmax / amax
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


def rounding(precision: str):
    """The rounding applied to every activation and weight: none for
    ``float32``, fp8 for ``fp8`` (the control)."""
    if precision == "float32":
        return lambda x: x
    if precision == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------- parameters
def _conv(name, co, ci, k):
    return [(f"{name}.weight", (co, ci, k, k, k)), (f"{name}.bias", (co,))]


def _bn(name, c):
    return [(f"{name}.bn.weight", (c,)), (f"{name}.bn.bias", (c,)),
            (f"{name}.bn.running_mean", (c,)),
            (f"{name}.bn.running_var", (c,))]


def _block(name, n, c, cin):
    out = []
    for i in range(n):
        out += _conv(f"{name}.conv_{i + 1}", c, cin if i == 0 else c, 5)
        out += _bn(f"{name}.norm_{i + 1}", c)
        out += [(f"{name}.act_{i + 1}.prelu.weight", (c,))]
    return out


def named_shapes(net: dict, prefix: str = "") -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every parameter and buffer, in module order."""
    ch, out = int(net["num_channel"]), []
    if int(net["in_channels"]) == 1:
        out += _bn("input_norm", ch)
    else:
        out += _conv("input_conv", ch, int(net["in_channels"]), 5)
        out += _bn("input_norm", ch) + [("input_act.prelu.weight", (ch,))]
    for level in range(int(net["num_levels"])):
        out += _block(f"encoder_level_{level + 1}",
                      int(net["num_convolutions"][level]), ch, ch)
        out += _conv(f"down_{level + 1}.conv", 2 * ch, ch, 2)
        out += _bn(f"down_{level + 1}.norm", 2 * ch)
        out += [(f"down_{level + 1}.act.prelu.weight", (2 * ch,))]
        ch *= 2
    out += _block("bottom", int(net["bottom_convolutions"]), ch, ch)
    for level in reversed(range(int(net["num_levels"]))):
        out += [(f"up_{level + 1}.deconv.weight", (ch, ch // 2, 2, 2, 2)),
                (f"up_{level + 1}.deconv.bias", (ch // 2,))]
        ch //= 2
        out += _bn(f"up_{level + 1}.norm", ch)
        out += [(f"up_{level + 1}.act.prelu.weight", (ch,))]
        out += _block(f"decoder_level_{level + 1}",
                      int(net["num_convolutions"][level]), ch, 2 * ch)
    out += _conv("output_conv", int(net["num_classes"]), ch, 1)
    out += _bn("output_norm", int(net["num_classes"]))
    return [(prefix + n, s) for n, s in out]


def dropout_layers(net: dict) -> List[str]:
    """The dropout layers' module paths, numbered by position (the
    stream of each layer's mask)."""
    out = []
    blocks = []
    for level in range(int(net["num_levels"])):
        blocks.append((f"encoder_level_{level + 1}",
                       int(net["num_convolutions"][level])))
    blocks.append(("bottom", int(net["bottom_convolutions"])))
    for level in reversed(range(int(net["num_levels"]))):
        blocks.append((f"decoder_level_{level + 1}",
                       int(net["num_convolutions"][level])))
    for name, n in blocks:
        out += [f"{name}.dropout_{i + 1}" for i in range(n)]
    return out


def params_only(weights: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in weights
            if not k.endswith(("running_mean", "running_var"))]


# ------------------------------------------------------------------ layers
class Ctx:
    """One forward pass: the parameters, the mode (``train``: batch
    statistics and dropout; ``eval``: running averages; ``calibrate``:
    batch statistics written into the running averages), the rounding,
    the dropout masks by layer path and whether units are checkpointed."""

    def __init__(self, P, mode: str, q, masks=None, keep: float = 1.0,
                 ckpt: bool = False):
        self.P, self.mode, self.q = P, mode, q
        self.masks = masks or {}
        self.keep, self.ckpt = keep, ckpt


def batch_norm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    P = ctx.P
    w, b = P[f"{name}.bn.weight"], P[f"{name}.bn.bias"]
    rm, rv = P[f"{name}.bn.running_mean"], P[f"{name}.bn.running_var"]
    if ctx.mode == "eval":
        y = F.batch_norm(x, rm, rv, w, b, training=False, eps=EPS)
    else:
        if ctx.mode == "calibrate":
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3, 4),
                                           unbiased=False)
                rm.copy_(mean)
                rv.copy_(var)
        y = F.batch_norm(x, None, None, w, b, training=True, eps=EPS)
    return ctx.q(y)


def conv(ctx: Ctx, name: str, x, stride: int = 1, transpose: bool = False):
    P, q = ctx.P, ctx.q
    w, b = q(P[f"{name}.weight"]), P[f"{name}.bias"]
    if transpose:
        y = F.conv_transpose3d(q(x), w, b, stride=2)
    else:
        k = w.shape[-1]
        y = F.conv3d(q(x), w, b, stride=stride,
                     padding=0 if stride > 1 else (k - 1) // 2)
    return q(y)


def prelu(ctx: Ctx, name: str, x):
    return ctx.q(F.prelu(x, ctx.P[f"{name}.prelu.weight"]))


def dropout(ctx: Ctx, name: str, x):
    mask = ctx.masks.get(name)
    if ctx.mode != "train" or mask is None:
        return x
    return ctx.q(torch.where(mask, x / ctx.keep, torch.zeros_like(x)))


def _unit(ctx, block, i, x, residual):
    y = conv(ctx, f"{block}.conv_{i}", x)
    if residual is not None:
        y = y + residual
    y = batch_norm(ctx, f"{block}.norm_{i}", y)
    y = prelu(ctx, f"{block}.act_{i}", y)
    return dropout(ctx, f"{block}.dropout_{i}", y)


def run(ctx: Ctx, fn, *args):
    """``fn(ctx, *args)``, checkpointed in training."""
    if ctx.ckpt and ctx.mode == "train" and torch.is_grad_enabled():
        return checkpoint(fn, ctx, *args, use_reentrant=False)
    return fn(ctx, *args)


def conv_block(ctx, block, n, x, residual=None):
    """``n`` units; the block input (or ``residual``) added at the last."""
    res = x if residual is None else residual
    for i in range(1, n + 1):
        x = run(ctx, _unit, block, i, x, res if i == n else None)
    return x


def _sampling(ctx, name, x, transpose):
    y = conv(ctx, f"{name}.deconv" if transpose else f"{name}.conv", x,
             stride=2, transpose=transpose)
    return prelu(ctx, f"{name}.act", batch_norm(ctx, f"{name}.norm", y))


def _input_layer(ctx, net, x):
    P = ctx.P
    if int(net["in_channels"]) > 1:
        y = batch_norm(ctx, "input_norm", conv(ctx, "input_conv", x))
        return prelu(ctx, "input_act", y)
    w, b = P["input_norm.bn.weight"], P["input_norm.bn.bias"]
    if ctx.mode == "eval":
        mean, var = P["input_norm.bn.running_mean"], P[
            "input_norm.bn.running_var"]
    else:
        var, mean = torch.var_mean(x, unbiased=False)
        if ctx.mode == "calibrate":
            P["input_norm.bn.running_mean"].fill_(float(mean))
            P["input_norm.bn.running_var"].fill_(float(var))
        mean, var = mean.expand_as(w), var.expand_as(w)
    inv = torch.rsqrt(var + EPS) * w
    return ctx.q(x * inv.view(1, -1, 1, 1, 1)
                 + (b - mean * inv).view(1, -1, 1, 1, 1))


def _output_layer(ctx, x):
    return batch_norm(ctx, "output_norm", conv(ctx, "output_conv", x))


def vnet(ctx: Ctx, net: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits ``(B, X, Y, Z, classes)`` of ``x`` ``(B, X, Y, Z, C)``."""
    x = x.permute(0, 4, 1, 2, 3)
    x = run(ctx, _input_layer, net, x)
    skips = []
    for level in range(int(net["num_levels"])):
        x = conv_block(ctx, f"encoder_level_{level + 1}",
                       int(net["num_convolutions"][level]), x)
        skips.append(x)
        x = run(ctx, _sampling, f"down_{level + 1}", x, False)
    x = conv_block(ctx, "bottom", int(net["bottom_convolutions"]), x)
    for level in reversed(range(int(net["num_levels"]))):
        up = run(ctx, _sampling, f"up_{level + 1}", x, True)
        x = conv_block(ctx, f"decoder_level_{level + 1}",
                       int(net["num_convolutions"][level]),
                       torch.cat([up, skips[level]], dim=1), residual=up)
    logits = run(ctx, _output_layer, x)
    return logits.permute(0, 2, 3, 4, 1)


def packing(spatial: Sequence[int], ch: int, target: int):
    """The per-axis packing of a level of extents ``spatial`` and ``ch``
    channels, or ``None``: just enough leading even axes packed by 2 that
    ``2^n * ch`` reaches ``target`` lanes (the layout the port computes a
    level in, which orders its dropout counter)."""
    n = 0
    while n < len(spatial) and (2 ** n) * ch < target:
        n += 1
    even = [i for i, d in enumerate(spatial) if d % 2 == 0]
    if target <= 0 or n < 1 or len(even) < n:
        return None
    return tuple(2 if i in even[:n] else 1 for i in range(len(spatial)))


def layer_shapes(net: dict, batch: int, patch: Sequence[int]) -> Dict[str, tuple]:
    """``(shape, packing)`` of every dropout layer's tensor: the JAX-layout
    shape ``(B, X, Y, Z, C)`` and the level's packing (``None``: none)."""
    out, ch = {}, int(net["num_channel"])
    lanes = int(net.get("packed_target_lanes", 0))
    for level in range(int(net["num_levels"])):
        s = tuple(-(-p // 2 ** level) for p in patch)
        c = ch * 2 ** level
        f = packing(s, c, lanes)
        for i in range(int(net["num_convolutions"][level])):
            for blk in ("encoder", "decoder"):
                out[f"{blk}_level_{level + 1}.dropout_{i + 1}"] = (
                    (batch, *s, c), f)
    lv = int(net["num_levels"])
    s = tuple(-(-p // 2 ** lv) for p in patch)
    f = packing(s, ch * 2 ** lv, lanes)
    for i in range(int(net["bottom_convolutions"])):
        out[f"bottom.dropout_{i + 1}"] = ((batch, *s, ch * 2 ** lv), f)
    return out


def packed_mask(shape, factors, seed: int, stream: int, rate: float,
                device) -> torch.Tensor:
    """The keep mask of a tensor of JAX-layout ``shape``, counted in the
    order of its packed layout ``(B, X/fx, Y/fy, Z/fz, [packed axes'
    offsets], C)`` and returned as ``(B, C, X, Y, Z)``."""
    if factors is None:
        return philox.keep_mask(shape, seed, stream, rate,
                                device).permute(0, 4, 1, 2, 3)
    b, x, y, z, c = shape
    fx, fy, fz = factors
    packed = ([b, x // fx, y // fy, z // fz]
              + [f for f in factors if f > 1] + [c])
    m = philox.keep_mask(packed, seed, stream, rate, device)
    m = m.reshape(b, x // fx, y // fy, z // fz, fx, fy, fz, c)
    m = m.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, x, y, z, c)
    return m.permute(0, 4, 1, 2, 3)


def masks(layers: List[str], shapes: Dict[str, tuple], seed: int,
          rate: float, device) -> Dict[str, torch.Tensor]:
    """Every dropout layer's keep mask for a step's ``seed``, ``(B, C, X,
    Y, Z)``; layer ``i`` of ``layers`` is stream ``i``."""
    return {name: packed_mask(*shapes[name], seed, i, rate, device)
            for i, name in enumerate(layers)}


# -------------------------------------------------------------------- loss
def dice_loss(logits, labels, classes: int, weights=()):
    """1 - the soft Sørensen coefficient, batch mean; with ``weights`` the
    weighted form sums the weighted numerators and denominators."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), classes).to(probs.dtype)
    axes = tuple(range(1, labels.dim()))
    inse = (probs * onehot).sum(axes)
    l, r = probs.sum(axes), onehot.sum(axes)
    if len(weights):
        w = torch.tensor(list(weights), dtype=probs.dtype,
                         device=probs.device)
        dice = ((2.0 * w * inse + SMOOTH).sum(-1)
                / (w * (l + r) + SMOOTH).sum(-1))
    else:
        dice = (2.0 * inse + SMOOTH) / (l + r + SMOOTH)
    return 1.0 - dice.mean()


def loss(logits, batch: dict, settings: dict):
    """The configuration's loss of one step."""
    lcfg = settings["loss"]
    return dice_loss(logits, batch["labels"], int(
        settings["network"]["num_classes"]), lcfg["weights"])


# -------------------------------------------------------------- training
def learning_rate(opt: dict, count: int) -> float:
    return opt["initial_learning_rate"] * opt["decay_factor"] ** (
        count / opt["decay_steps"])


def forward_train(P, settings, batch, seed, q, device):
    net = settings["network"]
    shapes = layer_shapes(net, batch["images"].shape[0],
                          batch["images"].shape[1:4])
    m = masks(dropout_layers(net), shapes, seed, net["dropout"], device)
    ctx = Ctx(P, "train", q, m, 1.0 - net["dropout"], ckpt=True)
    return vnet(ctx, net, batch["images"])


def train(weights: Dict[str, torch.Tensor], settings: dict,
          batches: List[dict], seeds: Sequence[int], forward_loss,
          precision: str = "float32", steps: int = 3,
          half_batch: bool = False) -> dict:
    """``steps`` training steps from ``weights`` on the host ``batches``
    with the steps' dropout ``seeds``: ``losses``, the first step's
    gradient norms by leaf (``grad_norms``) and the parameters after the
    last step (``params``, on the device). ``forward_loss(P, batch, seed,
    q)`` is the configuration's forward pass and loss. ``half_batch``
    (a fault the check must catch) trains on the first half of each
    batch."""
    device = next(iter(weights.values())).device
    q = rounding(precision)
    names = params_only(weights)
    P = {k: v.detach().clone() for k, v in weights.items()}
    for k in names:
        P[k].requires_grad_(True)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    b1, b2, eps = ADAM
    out = {"losses": [], "grad_norms": None}
    for step in range(steps):
        host = batches[step]
        rows = host["images"].shape[0] // 2 if half_batch else None
        batch = {k: torch.from_numpy(a[:rows]).to(device)
                 for k, a in host.items()}
        value = forward_loss(P, batch, seeds[step], q)
        grads = torch.autograd.grad(value, [P[k] for k in names])
        out["losses"].append(float(value.detach()))
        if step == 0:
            out["grad_norms"] = {k: float(g.double().norm())
                                 for k, g in zip(names, grads)}
        lr = learning_rate(settings["optimizer"], step)
        t = step + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                P[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del value, grads, batch
    out["params"] = {k: P[k].detach() for k in names}
    return out


def forward_loss(settings: dict):
    """The configuration's ``forward_loss`` for :func:`train`."""
    def fn(P, batch, seed, q):
        logits = forward_train(P, settings, batch, seed, q,
                               batch["images"].device)
        return loss(logits, batch, settings)
    return fn


# ------------------------------------------------------------ model FLOPs
def flops_per_voxel(net: dict) -> Fraction:
    """Forward FLOPs per input voxel of the V-Net (``yardstick.flops``);
    ``net`` holds ``in_channels``, ``num_channel``, ``num_levels``,
    ``num_convolutions``, ``bottom_convolutions`` and ``num_classes``.
    Level ``l`` holds ``1 / 8^l`` of the voxels."""
    c = flops.conv
    ch = int(net["num_channel"])
    total = Fraction(0)
    if int(net["in_channels"]) > 1:
        total += c(5, int(net["in_channels"]), ch)
    scale = Fraction(1)
    for level in range(int(net["num_levels"])):
        total += int(net["num_convolutions"][level]) * c(5, ch, ch) * scale
        scale /= 8
        total += 2 * 8 * ch * (2 * ch) * scale  # down: per coarse voxel
        ch *= 2
    total += int(net["bottom_convolutions"]) * c(5, ch, ch) * scale
    for level in reversed(range(int(net["num_levels"]))):
        total += 2 * 8 * ch * (ch // 2) * scale  # up: per coarse voxel
        ch //= 2
        scale *= 8
        n = int(net["num_convolutions"][level])
        total += (c(5, 2 * ch, ch) + (n - 1) * c(5, ch, ch)) * scale
    total += c(1, ch, int(net["num_classes"]))
    return total


# -------------------------------------------------------------- evaluation
def patch_starts(dim: int, patch: int, stride: int) -> List[int]:
    """Strided starts, the last clamped to end at the volume's edge."""
    n = max(int(math.ceil((dim - patch) / float(stride))) + 1, 1)
    return [max(min(i * stride, dim - patch), 0) for i in range(n)]


def cosine_window(patch: Sequence[int]) -> torch.Tensor:
    """The Gaussian blend's separable Hann window, floored at 0.05."""
    w = None
    for p in patch:
        x = (torch.arange(p, dtype=torch.float64) + 0.5) / p
        a = torch.clamp(torch.sin(math.pi * x), min=0.05)
        w = a if w is None else w[..., None] * a
    return w.float()


def calibrate(weights: Dict[str, torch.Tensor], net: dict,
              patches: torch.Tensor) -> None:
    """Set every batch norm's running averages to the batch statistics of
    ``patches`` ``(B, X, Y, Z, C)`` (in place), so that the evaluation's
    normalisation is that of data like it."""
    with torch.no_grad():
        vnet(Ctx(weights, "calibrate", rounding("float32")), net, patches)


def evaluate(weights, volume, net: dict, patch, stride, batch: int,
             gaussian: bool, apply=None, precision: str = "float32"):
    """The blended softmax sum and blend weight of a volume ``(X, Y, Z,
    C)`` on the weights' device: ``(X, Y, Z, 1 + classes)``, channel 0
    the weight. ``apply(ctx, patches)`` gives the logits (the backbone's
    by default)."""
    device = next(iter(weights.values())).device
    vol = torch.as_tensor(volume).to(device)
    apply = apply or (lambda ctx, x: vnet(ctx, net, x))
    ctx = Ctx(weights, "eval", rounding(precision))
    window = (cosine_window(patch) if gaussian
              else torch.ones(tuple(patch))).to(device)
    grid = [patch_starts(vol.shape[a], patch[a], stride[a]) for a in range(3)]
    starts = [(x, y, z) for x in grid[0] for y in grid[1] for z in grid[2]]
    acc = torch.zeros(tuple(vol.shape[:3]) + (1 + int(net["num_classes"]),),
                      device=device)
    px, py, pz = patch
    with torch.no_grad():
        for lo in range(0, len(starts), batch):
            rows = starts[lo:lo + batch]
            x = torch.stack([vol[a:a + px, b:b + py, c:c + pz]
                             for a, b, c in rows])
            probs = torch.softmax(apply(ctx, x).float(), dim=-1)
            for (a, b, c), p in zip(rows, probs):
                acc[a:a + px, b:b + py, c:c + pz, 0] += window
                acc[a:a + px, b:b + py, c:c + pz, 1:] += p * window[..., None]
    return acc
