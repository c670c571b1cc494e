"""Batch norm and the activation after it as one autograd Function, over a
(possibly packed) channels-last tensor: the CUDA kernels' wrappers and
their plain PyTorch versions.

The numerics are ``models/layers.py``'s eager chain (flax's BatchNorm, then
the activation in the compute dtype): float32 sums ``(sum x, sum x^2)`` per
packed channel over the rows of the channels-last storage, averaged over
the ranks of the caller's group, their offset groups added in order and
divided by the count (:func:`fold_moments`), the variance ``E[x^2] -
E[x]^2`` (clipped at 0 unpacked, unclipped packed), ``z = (x - mean) *
(rsqrt(var + eps) * gamma) + beta`` in float32 rounded once to ``x``'s
dtype, then ReLU, leaky ReLU 0.01, PReLU (``z > 0 ? z : alpha * z`` with
``alpha`` cast to the dtype) or none. Given the same sums the forward is
bitwise the chain's; the backward is the closed form of its gradient in
float32::

    dz = dy * act'(z),  inv = rsqrt(var + eps),  xhat = (x - mean) * inv
    dx = inv * gamma * (dz - sum(dz) / n - xhat * sum(dz * xhat) / n)
    dgamma = sum(dz * xhat), dbeta = sum(dz), dalpha = sum(dy * min(z, 0))

with the two sums of ``dx`` averaged over the ranks where the forward
averaged its sums (the backward of that mean), and the parameter
gradients the rank's own, as autograd of the chain gives them. With the
running averages (``batch=False``) ``dx = rsqrt(var + eps) * gamma * dz``.

Four passes, each a kernel for CUDA tensors and its plain version for any
other: :func:`moment_sums` (``ops/fused.py``'s ``bn_stats`` kernel, two
launches, counted in ``bn_stats.launches``), :func:`bn_act_apply` (one
launch of ``csrc/bn_act.cu``; it folds the groups, writes the saved ``(mean,
inv)`` and updates the running averages), :func:`bn_act_grad_sums` (two:
block partials, then their sum folded over the groups) and
:func:`bn_act_dx` (one). A CUDA tensor never falls back. Each wrapper's
``.launches`` counts its calls on the card. The Function saves only its
input, the per-channel float32 ``(mean, inv)`` and the parameters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..parallel.mesh import group_mean
from . import build
from .fused import _DTYPES, _aligned, bn_sums, split_rows

ACTS = {"none": 0, "relu": 1, "lrelu": 2, "prelu": 3}
RUNNING, MOMENTS, CLIPPED = 0, 1, 2  # apply's statistics: running, sums
EPS = 1e-3
MOMENTUM = 0.99
LEAKY_SLOPE = 0.01  # flax nn.leaky_relu's default


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _grouped(x: torch.Tensor, groups: int):
    """``x`` ``(B, G*C, *spatial)`` as the view the statistics reduce over
    (``(B, G, C, *spatial)`` packed, a view of channels-last storage), its
    reduction axes and the shape that broadcasts a ``(C,)`` vector over
    it."""
    if groups == 1:
        return (x, (0,) + tuple(range(2, x.ndim)),
                (1, -1) + (1,) * (x.ndim - 2))
    c = x.shape[1] // groups
    xg = x.reshape((x.shape[0], groups, c) + tuple(x.shape[2:]))
    return (xg, (0, 1) + tuple(range(3, xg.ndim)),
            (1, 1, c) + (1,) * (x.ndim - 2))


def moment_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """``(2, G*C)`` float32 ``(sum x, sum x^2)`` per packed channel over the
    batch and the spatial axes, as ``bn_stats_plain`` sums the rows of the
    channels-last storage; differentiable, any device and dtype."""
    xf = x.movedim(1, -1).reshape(-1, x.shape[1]).float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def fold_moments(sums: torch.Tensor, groups: int, n: int) -> torch.Tensor:
    """``(2, C)`` ``(E[x], E[x^2])`` of ``(2, G*C)`` sums over ``n`` values a
    base channel: the G groups added in order in float32, then divided in
    float64 (``bn_act_apply_kernel``'s arithmetic); differentiable."""
    c = sums.shape[-1] // groups
    s = sums[..., :c]
    for g in range(1, groups):
        s = s + sums[..., g * c:(g + 1) * c]
    return (s.double() / n).float()


def normalize_plain(x: torch.Tensor, first: torch.Tensor,
                    second: torch.Tensor, kind: int, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int = 1):
    """``(y, mean, var)``: ``y = (x - mean) * (rsqrt(var + eps) * weight) +
    bias`` in float32, rounded to ``x``'s dtype. ``(first, second)`` are the
    running ``(mean, var)`` (``kind`` :data:`RUNNING`) or the sums ``(sum x,
    sum x^2)`` per packed channel (:data:`MOMENTS`; :data:`CLIPPED`: the
    variance clipped at 0), folded by :func:`fold_moments`.
    Differentiable; any device."""
    if kind == RUNNING:
        mean, var = first, second
    else:
        mean, sq = fold_moments(torch.stack([first, second]), groups,
                                _count(x, groups)).unbind(0)
        var = sq - mean.square()
    if kind == CLIPPED:
        var = torch.clamp_min(var, 0.0)
    mul = torch.rsqrt(var + EPS) * weight
    xg, _, view = _grouped(x, groups)
    y = ((xg.float() - mean.view(view)) * mul.view(view)
         + bias.view(view))
    return y.to(x.dtype).reshape(x.shape), mean, var


def activation_plain(y: torch.Tensor, act: str,
                     alpha: Optional[torch.Tensor] = None,
                     groups: int = 1) -> torch.Tensor:
    """The activation ``act`` of ``y`` in its dtype: ``F.relu``,
    ``F.leaky_relu(y, 0.01)``, ``max(y, 0) + alpha * min(y, 0)`` with the
    per-channel ``alpha`` cast to the dtype and tiled over ``groups`` offset
    groups, or ``y`` itself; differentiable, any device."""
    if act == "relu":
        return F.relu(y)
    if act == "lrelu":
        return F.leaky_relu(y, LEAKY_SLOPE)
    if act == "prelu":
        a = alpha.to(y.dtype)
        if groups > 1:
            a = a.repeat(groups)
        a = a.view((1, -1) + (1,) * (y.ndim - 2))
        return torch.clamp_min(y, 0) + a * torch.clamp_max(y, 0)
    if act == "none":
        return y
    raise ValueError(f"Unknown activation {act!r}; expected one of "
                     f"{tuple(ACTS)}")


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """``running = 0.99 * running + 0.01 * batch`` (flax's update, the
    biased batch variance), in place."""
    running_mean.copy_(MOMENTUM * running_mean + (1.0 - MOMENTUM) * mean)
    running_var.copy_(MOMENTUM * running_var + (1.0 - MOMENTUM) * var)


def bn_act_apply_plain(x, first, second, kind, weight, bias, alpha, act,
                       groups=1, running=None):
    """``(y, saved)``: :func:`normalize_plain`, then :func:`activation_plain`;
    ``saved`` ``(2, C)`` float32 ``(mean, inv)``. ``running``: the
    ``(running_mean, running_var)`` to fold the statistics into. Any
    device."""
    z, mean, var = normalize_plain(x, first, second, kind, weight, bias,
                                   groups)
    if running is not None:
        update_running(*running, mean, var)
    saved = torch.stack([mean, torch.rsqrt(var + EPS)])
    return activation_plain(z, act, alpha, groups), saved


def _recompute(x, saved, weight, bias, groups):
    """``(z, xhat)`` of the backward, as the grouped view in float32: the
    forward's ``z`` (rounded to ``x``'s dtype) and ``(x - mean) * inv``."""
    xg, _, view = _grouped(x, groups)
    xc = xg.float() - saved[0].view(view)
    z = xc * (saved[1] * weight).view(view) + bias.view(view)
    return z.to(x.dtype).float(), xc * saved[1].view(view)


def _dz(dy, z, act, alpha, groups):
    """``dy * act'(z)`` in float32 (``dy`` the grouped view)."""
    dyf = _grouped(dy, groups)[0].float()
    if act == "none":
        return dyf
    if act == "prelu":
        slope = alpha.to(dy.dtype).float().view(_grouped(dy, groups)[2])
    else:
        slope = 0.0 if act == "relu" else LEAKY_SLOPE
    return torch.where(z > 0, dyf, dyf * slope)


def bn_act_grad_sums_plain(dy, x, saved, weight, bias, alpha, act,
                           groups=1) -> torch.Tensor:
    """``(K, C)`` float32 of the rank's own rows: ``sum(dz)``, ``sum(dz *
    xhat)`` and, for PReLU (K = 3), ``sum(dy * min(z, 0))``; any device."""
    axes = _grouped(x, groups)[1]
    z, xhat = _recompute(x, saved, weight, bias, groups)
    dz = _dz(dy, z, act, alpha, groups)
    sums = [dz.sum(axes), (dz * xhat).sum(axes)]
    if act == "prelu":
        dyf = _grouped(dy, groups)[0].float()
        sums.append((dyf * torch.clamp_max(z, 0)).sum(axes))
    return torch.stack(sums)


def bn_act_dx_plain(dy, x, saved, weight, bias, alpha, sums, act,
                    groups=1) -> torch.Tensor:
    """``dx`` in ``x``'s dtype; ``sums`` ``(2, C)``: ``sum(dz)``, ``sum(dz *
    xhat)`` averaged over the ranks, or ``None`` with running averages. Any
    device."""
    view = _grouped(x, groups)[2]
    z, xhat = _recompute(x, saved, weight, bias, groups)
    dz = _dz(dy, z, act, alpha, groups)
    if sums is not None:
        n = _count(x, groups)
        dz = dz - (sums[0] / n).view(view) - xhat * (sums[1] / n).view(view)
    return ((saved[1] * weight).view(view) * dz).to(x.dtype).reshape(x.shape)


def _count(x: torch.Tensor, groups: int) -> int:
    """Elements of one base channel: batch x spatial x groups."""
    return x.numel() // (x.shape[1] // groups)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------
@functools.cache
def _lib():
    lib = build.load("bn_act").lib
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    geometry = [ll, i, i, i, i, ll, p]  # rows, Cp, C, vec, chunks, ..., stream
    lib.vnet_bn_act_apply.argtypes = ([p, p, p, p, i, ll, p, p, p, p, p, p,
                                       f, f, f, i, i] + geometry)
    lib.vnet_bn_act_grad_sums.argtypes = [p] * 8 + [i, i] + geometry
    lib.vnet_bn_act_dx.argtypes = [p] * 8 + [ll, i, i] + geometry
    for fn in (lib.vnet_bn_act_apply, lib.vnet_bn_act_grad_sums,
               lib.vnet_bn_act_dx):
        fn.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``(B, *spatial, Cp)`` contiguous: a view of channels-last storage, a
    copy of any other layout."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_act takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    xs = x.movedim(1, -1)
    return xs if xs.is_contiguous() else xs.contiguous()


def _geometry(*rows: torch.Tensor):
    """``(rows, Cp, vec, chunks, chunk_rows)`` of row-major tensors of one
    shape, split as ``bn_stats``' partials are."""
    r = rows[0]
    cp = r.shape[-1]
    n = r.numel() // cp
    if n == 0:
        raise ValueError(f"bn_act needs at least one row, got "
                         f"{tuple(r.shape)}")
    size = r.element_size()
    vec = int((cp * size) % 16 == 0 and _aligned(*rows))
    chunks, chunk_rows = split_rows(n, cp, vec, size)
    return n, cp, vec, chunks, chunk_rows


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _f32(*ts: Optional[torch.Tensor]):
    """Per-channel vectors as contiguous float32 (the parameters and the
    statistics already are: passed as they are)."""
    return [t if t is None or (t.dtype == torch.float32
                               and t.is_contiguous())
            else t.detach().float().contiguous() for t in ts]


def moment_sums(x: torch.Tensor) -> torch.Tensor:
    """:func:`moment_sums_plain`; CUDA tensors launch ``ops/fused.py``'s
    ``bn_stats`` kernel over the rows."""
    if not x.is_cuda:
        return moment_sums_plain(x)
    return bn_sums(_rows(x))


def bn_act_apply(x, first, second, kind, weight, bias, alpha, act, groups=1,
                 running=None):
    """:func:`bn_act_apply_plain`; CUDA tensors launch ``csrc/bn_act.cu``
    (one kernel: each block folds the sums, the first writes ``saved`` and
    the running averages). ``y`` is channels-last as ``x`` is."""
    if not x.is_cuda:
        return bn_act_apply_plain(x, first, second, kind, weight, bias,
                                  alpha, act, groups, running)
    xr = _rows(x)
    rows, cp, vec, chunks, chunk_rows = _geometry(xr)
    c = cp // groups
    first, second, weight, bias, alpha = _f32(first, second, weight, bias,
                                              alpha)
    rm, rv = running if running is not None else (None, None)
    for t in (rm, rv):
        if t is not None and not (t.dtype == torch.float32
                                  and t.is_contiguous()):
            raise TypeError("running averages must be contiguous float32")
    y = torch.empty_like(xr)
    saved = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(_lib().vnet_bn_act_apply, "bn_act_apply", xr.data_ptr(),
                y.data_ptr(), first.data_ptr(), second.data_ptr(), kind,
                _count(x, groups), weight.data_ptr(), bias.data_ptr(), _ptr(alpha),
                saved.data_ptr(), _ptr(rm), _ptr(rv), MOMENTUM,
                1.0 - MOMENTUM, EPS, ACTS[act], _DTYPES[x.dtype], rows, cp,
                c, vec, chunks, chunk_rows, _stream(x.device))
    bn_act_apply.launches += 1
    return y.movedim(-1, 1), saved


bn_act_apply.launches = 0


def bn_act_grad_sums(dy, x, saved, weight, bias, alpha, act, groups=1):
    """:func:`bn_act_grad_sums_plain`; CUDA tensors launch
    ``csrc/bn_act.cu`` (block partials, then their sum folded over the
    groups)."""
    if not x.is_cuda:
        return bn_act_grad_sums_plain(dy, x, saved, weight, bias, alpha, act,
                                      groups)
    xr, dyr = _rows(x), _rows(dy)
    rows, cp, vec, chunks, chunk_rows = _geometry(xr, dyr)
    c = cp // groups
    k = 3 if act == "prelu" else 2
    weight, bias, alpha = _f32(weight, bias, alpha)
    partial = torch.empty(chunks * k * cp, dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((k, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(_lib().vnet_bn_act_grad_sums, "bn_act_grad_sums",
                dyr.data_ptr(), xr.data_ptr(), saved.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), _ptr(alpha),
                partial.data_ptr(), sums.data_ptr(), ACTS[act],
                _DTYPES[x.dtype], rows, cp, c, vec, chunks, chunk_rows,
                _stream(x.device))
    bn_act_grad_sums.launches += 1
    return sums


bn_act_grad_sums.launches = 0


def bn_act_dx(dy, x, saved, weight, bias, alpha, sums, act, groups=1):
    """:func:`bn_act_dx_plain`; CUDA tensors launch ``csrc/bn_act.cu`` (one
    kernel). ``dx`` is channels-last as ``x`` is."""
    if not x.is_cuda:
        return bn_act_dx_plain(dy, x, saved, weight, bias, alpha, sums, act,
                               groups)
    xr, dyr = _rows(x), _rows(dy)
    rows, cp, vec, chunks, chunk_rows = _geometry(xr, dyr)
    c = cp // groups
    weight, bias, alpha, sums = _f32(weight, bias, alpha, sums)
    dx = torch.empty_like(xr)
    with torch.cuda.device(x.device):
        _launch(_lib().vnet_bn_act_dx, "bn_act_dx", dyr.data_ptr(),
                xr.data_ptr(), dx.data_ptr(), saved.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), _ptr(alpha), _ptr(sums),
                _count(x, groups), ACTS[act], _DTYPES[x.dtype], rows, cp, c,
                vec, chunks, chunk_rows, _stream(x.device))
    bn_act_dx.launches += 1
    return dx.movedim(-1, 1)


bn_act_dx.launches = 0


# ----------------------------------------------------------------------
# the Function
# ----------------------------------------------------------------------
class _BatchNormAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, alpha, running_mean, running_var,
                groups, act, batch, update, group):
        if batch:
            sums = moment_sums(x)
            if group is not None:
                sums = group_mean(sums, *group)
            first, second = sums.unbind(0)
            kind = CLIPPED if groups == 1 else MOMENTS
        else:
            first, second, kind = running_mean, running_var, RUNNING
        y, saved = bn_act_apply(
            x, first, second, kind, weight, bias, alpha, act, groups,
            (running_mean, running_var) if update else None)
        ctx.save_for_backward(x, saved, weight, bias, alpha)
        ctx.groups, ctx.act, ctx.batch, ctx.group = groups, act, batch, group
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, saved, weight, bias, alpha = ctx.saved_tensors
        args = (x, saved, weight, bias, alpha)
        sums = bn_act_grad_sums(dy, *args, ctx.act, ctx.groups)
        dx = None
        if ctx.needs_input_grad[0]:
            mean_sums = None
            if ctx.batch:
                mean_sums = sums[:2]
                if ctx.group is not None:
                    mean_sums = group_mean(mean_sums, *ctx.group)
            dx = bn_act_dx(dy, *args, mean_sums, ctx.act, ctx.groups)
        dalpha = sums[2] if ctx.act == "prelu" else None
        return (dx, sums[1], sums[0], dalpha, None, None, None, None, None,
                None, None)


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, *,
                   act: str = "none", alpha: Optional[torch.Tensor] = None,
                   groups: int = 1, batch: bool = True, update: bool = False,
                   group: Optional[Tuple] = None) -> torch.Tensor:
    """``act(batch_norm(x))`` of ``x`` ``(B, groups * C, *spatial)`` (or
    ``(B, C)``) with float32 ``weight``, ``bias``, running averages and, for
    ``act="prelu"``, ``alpha``, all ``(C,)``. ``batch``: the batch's
    statistics, averaged over the ``(process group, size)`` ``group`` when
    given, and folded into the running averages in place when ``update``;
    else the running averages. Differentiable in ``x``, ``weight``,
    ``bias`` and ``alpha``."""
    if act not in ACTS:
        raise ValueError(f"Unknown activation {act!r}; expected one of "
                         f"{tuple(ACTS)}")
    if (alpha is not None) != (act == "prelu"):
        raise ValueError("alpha is PReLU's slope: given for act='prelu' "
                         "only")
    c = weight.shape[0]
    if x.ndim < 2 or groups < 1 or x.shape[1] != groups * c:
        raise ValueError(f"x {tuple(x.shape)} has no {groups} x {c} "
                         f"channels on axis 1")
    if update and not batch:
        raise ValueError("update needs the batch's statistics")
    return _BatchNormAct.apply(x, weight, bias, alpha, running_mean,
                               running_var, int(groups), act, bool(batch),
                               bool(update), group)
