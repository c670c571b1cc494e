"""Shifted-window attention of a Swin block as one autograd Function: the
CUDA kernels' wrappers (``csrc/window_attention.cu``) and their plain
PyTorch version.

MONAI's ``WindowAttention`` (``monai/networks/nets/swin_unetr.py``) from
the qkv projection on: with ``q, k, v`` the ``(BW, heads, N, d)`` views of
``qkv`` ``(BW, N, 3C)`` (``C = heads * d``)::

    S = (q * scale) k^T + table[index] + mask,   P = softmax(S) in float32,
    O = P v,  returned as (BW, N, C), head-major within a token

``table`` is the ``(T, heads)`` relative-position bias, ``index`` the
``(N, N)`` rows of its index the window uses (MONAI slices the configured
window's index to ``[:N, :N]``), ``regions`` for a shifted block the
``(nW, N)`` region of ``compute_mask``'s slices each token of window ``w``
comes from (window row ``b`` is window ``b % nW``): tokens of two regions
get ``-100`` added. The padded tokens of the grid are keys like any other,
as in MONAI.

CUDA tensors (bfloat16, head width 16, ``N`` up to 343) launch the kernels:
the forward (``window_attention_fwd``: O and the rows' log-sum-exp) and,
in the backward, ``window_attention_bwd`` (dq, dk, dv into one gradient of
``qkv``, and ``D = rowsum(dO * O)``) and ``window_attention_dbias`` (two
launches: per-group partial sums of ``dS`` over the windows, then their
sum; the wrapper ``index_add``s it into the table's gradient). No ``(BW,
heads, N, N)`` tensor is written in either direction; the Function saves
``qkv``, ``O``, the log-sum-exp and the small tables. Each wrapper's
``.launches`` counts its calls on the card. Any other tensor takes
:func:`window_attention_plain`, which computes the scores explicitly; a
CUDA tensor never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..profiler import span
from . import build

HEAD_WIDTH = 16    # the kernels' head width (Swin UNETR's in every stage)
MAX_TOKENS = 343   # the kernels' largest window, 7^3
MASK_VALUE = -100.0
TARGET_BLOCKS = 132 * 8  # bias-gradient partial blocks to aim for


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------
def gathered_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``(heads, N, N)`` float32: ``table[index]`` with the heads first."""
    n = index.shape[0]
    return (table.float()[index.reshape(-1)].view(n, n, -1)
            .permute(2, 0, 1).contiguous())


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """``(nW, N, N)`` float32: -100 where two tokens' regions differ."""
    diff = regions[:, :, None] != regions[:, None, :]
    return diff.float() * MASK_VALUE


def window_attention_plain(qkv: torch.Tensor, heads: int,
                           table: torch.Tensor, index: torch.Tensor,
                           regions: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The attention with the scores computed explicitly, in MONAI's order
    (``q`` scaled in its dtype, scores plus bias and mask and the softmax in
    float32, ``P`` cast back to ``v``'s dtype); differentiable, any
    device."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = d ** -0.5 if scale is None else scale
    q, k, v = qkv.view(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    s = ((q * scale) @ k.transpose(-2, -1)).float()
    s = s + gathered_bias(table, index).unsqueeze(0)
    if regions is not None:
        nw = regions.shape[0]
        s = (s.view(bw // nw, nw, heads, n, n)
             + region_mask(regions).unsqueeze(1).unsqueeze(0)
             ).view(bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p @ v).transpose(1, 2).reshape(bw, n, c)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------
@functools.cache
def _lib():
    lib = build.load("window_attention").lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vnet_swin_wattn_fwd.argtypes = [p] * 5 + [i] * 4 + [f, p]
    lib.vnet_swin_wattn_bwd.argtypes = [p] * 8 + [i] * 4 + [f, p]
    lib.vnet_swin_wattn_dbias.argtypes = [p] * 8 + [i] * 5 + [f, p]
    for fn in (lib.vnet_swin_wattn_fwd, lib.vnet_swin_wattn_bwd,
               lib.vnet_swin_wattn_dbias):
        fn.restype = ctypes.c_int
    return lib


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _checked(qkv: torch.Tensor, heads: int, regions) -> tuple:
    """``(bw, n, nw)`` of a ``qkv`` the kernels take, else raises."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the window-attention kernels take bfloat16, got "
                        f"{qkv.dtype}")
    bw, n, c3 = qkv.shape
    if c3 != 3 * heads * HEAD_WIDTH:
        raise ValueError(f"the kernels take heads of width {HEAD_WIDTH}: "
                         f"qkv {tuple(qkv.shape)} with {heads} heads")
    if n > MAX_TOKENS:
        raise ValueError(f"windows of at most {MAX_TOKENS} tokens, got {n}")
    nw = 1 if regions is None else regions.shape[0]
    if bw % nw:
        raise ValueError(f"{bw} window rows are not a multiple of {nw} "
                         f"windows")
    return bw, n, nw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def window_attention_fwd(qkv, heads, bias, regions, scale):
    """``(O, lse)``: ``O`` ``(BW, N, C)`` bf16 and the rows' float32
    log-sum-exp ``(BW, heads, N)``; ``bias`` the gathered ``(heads, N, N)``
    float32, ``regions`` ``(nW, N)`` int32 or ``None``. One launch."""
    bw, n, nw = _checked(qkv, heads, regions)
    out = torch.empty((bw, n, heads * HEAD_WIDTH), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((bw, heads, n), dtype=torch.float32,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch(_lib().vnet_swin_wattn_fwd, "swin_wattn_fwd",
                qkv.data_ptr(), bias.data_ptr(), _ptr(regions),
                out.data_ptr(), lse.data_ptr(), bw, heads, n, nw,
                float(scale), _stream(qkv.device))
    window_attention_fwd.launches += 1
    return out, lse


window_attention_fwd.launches = 0


def window_attention_bwd(qkv, out, dout, lse, heads, bias, regions, scale):
    """``(dqkv, D)``: the gradient of ``qkv`` (bf16, its shape) and
    ``D = rowsum(dO * O)`` ``(BW, heads, N)`` float32. One launch."""
    bw, n, nw = _checked(qkv, heads, regions)
    dqkv = torch.empty_like(qkv)
    dvec = torch.empty_like(lse)
    with torch.cuda.device(qkv.device):
        _launch(_lib().vnet_swin_wattn_bwd, "swin_wattn_bwd",
                qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), bias.data_ptr(), _ptr(regions),
                dqkv.data_ptr(), dvec.data_ptr(), bw, heads, n, nw,
                float(scale), _stream(qkv.device))
    window_attention_bwd.launches += 1
    return dqkv, dvec


window_attention_bwd.launches = 0


def dbias_groups(bw: int, heads: int, n: int) -> int:
    """Window groups of the bias gradient's partials: about
    ``TARGET_BLOCKS`` blocks (heads x query tiles x groups), each group
    holding at least one window."""
    tiles = -(-n // HEAD_WIDTH)
    groups = max(1, min(bw, -(-TARGET_BLOCKS // (heads * tiles))))
    per = -(-bw // groups)
    return -(-bw // per)


def window_attention_dbias(qkv, dout, lse, dvec, heads, bias, regions,
                           scale):
    """``(heads, N, N)`` float32: ``dS`` summed over the window rows
    (per-group partials, then their sum in a fixed order). One call, two
    launches."""
    bw, n, nw = _checked(qkv, heads, regions)
    groups = dbias_groups(bw, heads, n)
    partial = torch.empty((groups, heads, n, n), dtype=torch.float32,
                          device=qkv.device)
    dbias = torch.empty((heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch(_lib().vnet_swin_wattn_dbias, "swin_wattn_dbias",
                qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                dvec.data_ptr(), bias.data_ptr(), _ptr(regions),
                partial.data_ptr(), dbias.data_ptr(), bw, heads, n, nw,
                groups, float(scale), _stream(qkv.device))
    window_attention_dbias.launches += 1
    return dbias


window_attention_dbias.launches = 0


# ----------------------------------------------------------------------
# the Function
# ----------------------------------------------------------------------
class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, table, index, regions, heads, scale):
        out, lse = window_attention_fwd(
            qkv, heads, gathered_bias(table.detach(), index), regions, scale)
        ctx.save_for_backward(qkv, out, lse, table, index, regions)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        qkv, out, lse, table, index, regions = ctx.saved_tensors
        bias = gathered_bias(table.detach(), index)
        dout = dout.contiguous()
        dqkv, dvec = window_attention_bwd(qkv, out, dout, lse, ctx.heads,
                                          bias, regions, ctx.scale)
        dtable = None
        if ctx.needs_input_grad[1]:
            dbias = window_attention_dbias(qkv, dout, lse, dvec, ctx.heads,
                                           bias, regions, ctx.scale)
            dtable = torch.zeros(table.shape, dtype=torch.float32,
                                 device=qkv.device)
            dtable.index_add_(0, index.reshape(-1),
                              dbias.permute(1, 2, 0).reshape(
                                  -1, ctx.heads))
        return dqkv, dtable, None, None, None, None


def window_attention(qkv: torch.Tensor, heads: int, table: torch.Tensor,
                     index: torch.Tensor,
                     regions: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The shifted-window attention of ``qkv`` ``(BW, N, 3C)`` with
    ``heads`` heads: ``(BW, N, C)`` (module docstring). ``table`` the
    float32 ``(T, heads)`` bias table, ``index`` ``(N, N)`` integer rows of
    its index, ``regions`` the ``(nW, N)`` region ids of a shifted block
    or ``None``; ``scale`` defaults to ``head_width ** -0.5``.
    Differentiable in ``qkv`` and ``table``; each call is one
    ``vnet.swin.window_attention`` span."""
    with span("vnet.swin.window_attention"):
        if not qkv.is_cuda:
            return window_attention_plain(qkv, heads, table, index, regions,
                                          scale)
        d = qkv.shape[-1] // (3 * heads)
        scale = d ** -0.5 if scale is None else float(scale)
        if not qkv.is_contiguous():
            qkv = qkv.contiguous()
        index = index.to(device=qkv.device, dtype=torch.long)
        if regions is not None:
            regions = regions.to(device=qkv.device,
                                 dtype=torch.int32).contiguous()
        return _WindowAttention.apply(qkv, table, index, regions, heads,
                                      scale)


__all__ = ["window_attention", "window_attention_plain", "gathered_bias",
           "region_mask", "dbias_groups", "HEAD_WIDTH", "MAX_TOKENS",
           "MASK_VALUE"]
