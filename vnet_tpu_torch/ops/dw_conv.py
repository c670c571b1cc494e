"""Weight gradient of stride-1 SAME 3D convolutions: the CUDA kernels'
wrapper and planner, their plain PyTorch version, and the convolution whose
backward pass uses them.

Counterpart of ``vnet_tpu/ops/pallas/dw_conv.py`` (``dw_conv_pallas`` and
``conv_pallas_dw``):

    dW[co, ci, o] = sum_{b, p} x[b, p + o - lo, ci] * g[b, p, co]

summed in float32, ``lo = (k - 1) // 2`` per axis, x zero outside the
volume (``vnet_tpu/ops/conv_vjp.py:75-77``). Tensors keep the port's
logical ``(B, C, X, Y, Z)`` shape; the kernels (``csrc/dw_conv.cu``) read
channels-last storage, the JAX layout. The JAX kernel's scope limits
(lane-aligned channels, at most 27 offsets) came from Mosaic and do not
apply: every stride-1 convolution with an odd kernel is in scope.

:func:`plan` picks the kernel and its split for a shape (a
:class:`Plan`): bf16 and f16 with channels in multiples of 16 and a kernel
z extent of 1, 3, 5 or 7 go to the tensor-core kernel, ``narrow`` where one
block holds every channel pair (Ci x Co <= 512) and ``wide`` where channel
tiles spread over blocks; float32 (exact f32 products, no TF32) and the
rest go to the CUDA-core kernel (``simt``). :func:`dw_conv` launches the
planned kernel for CUDA tensors and takes :func:`dw_conv_plain` only for
CPU tensors; a CUDA tensor never falls back. ``dw_conv.launches`` counts
kernel launches (one per weight gradient).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POSITIONS_PER_STEP = 64       # DW_PT in the .cu source
TARGET_BLOCKS = 132 * 32      # CUDA-core partial-sum blocks to aim for
MAX_CHUNKS = 65535            # gridDim.y / gridDim.z
MMA_KZ = (1, 3, 5, 7)         # kernel z extents of its instantiations
MMA_SMEM = 227 * 1024         # MMA_SMEM_MAX: dynamic shared memory per block
BRICK_POSITIONS = 256         # output positions per brick and warp slab
MMA_STAGES = 2                # bricks in flight per block
MMA_TARGET_BLOCKS = 132 * 16  # tensor-core blocks to aim for (132 SMs)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one weight gradient is split. ``regime`` is ``"narrow"`` or
    ``"wide"`` (tensor cores) or ``"simt"`` (CUDA cores). Tensor cores:
    block channel ``tiles`` ``(tci, tco)`` of one or two 16 x 16 warp slabs,
    ``brick`` ``(bb, bx, by, bz)`` of output positions, ``ry`` oy rows per
    block (one warp row each), ``stages`` bricks in flight per block,
    ``chunks`` of ``per_chunk`` bricks, ``smem`` bytes of shared memory per
    block. CUDA cores: ``chunks`` of ``per_chunk`` positions."""

    regime: str
    chunks: int
    per_chunk: int
    tiles: Tuple[int, int] = (0, 0)
    brick: Tuple[int, int, int, int] = (0, 0, 0, 0)
    ry: int = 0
    stages: int = 0
    smem: int = 0

    def bricks(self, batch: int, vol: Sequence[int]) -> int:
        """Bricks that cover ``batch`` volumes ``vol``."""
        return math.prod(-(-n // b) for n, b in zip((batch, *vol),
                                                    self.brick))

    def blocks_per_chunk(self, kernel_size: Sequence[int], ci: int,
                         co: int) -> int:
        """Tensor-core blocks per chunk: offset-plane groups x tiles."""
        kx, ky, _ = kernel_size
        return (kx * -(-ky // self.ry) * (ci // self.tiles[0])
                * (co // self.tiles[1]))

    def threads(self) -> int:
        """Tensor-core threads per block: a warp per oy row and slab."""
        return 32 * self.ry * (self.tiles[0] // 16) * (self.tiles[1] // 16)


def _check(x: torch.Tensor, g: torch.Tensor, kernel_size: Sequence[int]):
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"expected x (B, Ci, X, Y, Z) and g (B, Co, X, Y, "
                         f"Z), got {tuple(x.shape)} and {tuple(g.shape)}")
    if x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ "
                         "in batch or volume (stride 1, SAME)")
    if len(kernel_size) != 3 or any(k < 1 or k % 2 == 0
                                    for k in kernel_size):
        raise ValueError(f"odd kernel sizes only, got {kernel_size}")
    if x.dtype != g.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"x and g must share a float32, bfloat16 or float16 "
                        f"dtype, got {x.dtype} and {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")


def dw_conv_plain(x: torch.Tensor, g: torch.Tensor,
                  kernel_size: Sequence[int]) -> torch.Tensor:
    """A loop over kernel offsets of float32 contractions of shifted views
    of the zero-padded input; any device. Returns ``(Co, Ci, *k)`` f32."""
    _check(x, g, kernel_size)
    ks = tuple(int(k) for k in kernel_size)
    vol = x.shape[2:]
    pad = []
    for k in reversed(ks):
        pad += [(k - 1) // 2, k // 2]
    xp = F.pad(x.float(), pad)
    gf = g.float()
    out = torch.empty((g.shape[1], x.shape[1]) + ks, dtype=torch.float32,
                      device=x.device)
    for a, b, c in itertools.product(*(range(k) for k in ks)):
        window = xp[:, :, a:a + vol[0], b:b + vol[1], c:c + vol[2]]
        out[:, :, a, b, c] = torch.einsum("bixyz,boxyz->oi", window, gf)
    return out


def split(positions: int, offsets: int, channel_tiles: int) -> Tuple[int, int]:
    """``(chunks, chunk_len)`` of the CUDA-core kernel: the positions split
    into chunks so that about ``TARGET_BLOCKS`` blocks share the work, each
    chunk a whole number of staging steps."""
    steps = -(-positions // POSITIONS_PER_STEP)
    want = -(-TARGET_BLOCKS // (offsets * channel_tiles))
    chunks = max(1, min(steps, want, MAX_CHUNKS))
    chunk_len = -(-steps // chunks) * POSITIONS_PER_STEP
    return -(-positions // chunk_len), chunk_len


def _tile(c: int) -> int:
    """CUDA-core channel tile per side (``tile`` in the .cu source)."""
    t = 4
    while t < c and t < 64:
        t *= 2
    return t


def _pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def mma_smem(tiles: Tuple[int, int], brick: Sequence[int], ry: int,
             kz: int, stages: int) -> int:
    """Shared memory of a tensor-core block: per stage, the x box (the
    brick plus its halo of ``ry - 1`` rows in y and ``kz - 1`` in z) and
    the g brick, rows of 16-bit values padded by 16 bytes; a row table of 4
    bytes per brick position; an 8-byte barrier per stage (as
    ``vnet_dw_conv_mma`` sizes them)."""
    bb, bx, by, bz = brick
    positions = bb * bx * by * bz
    x_bytes = -(-bb * bx * (by + ry - 1) * (bz + kz - 1)
                * (2 * tiles[0] + 16) // 128) * 128
    g_bytes = -(-positions * (2 * tiles[1] + 16) // 128) * 128
    return stages * (x_bytes + g_bytes + 8) + 4 * positions


def plan(batch: int, vol: Sequence[int], ci: int, co: int,
         kernel_size: Sequence[int], dtype: torch.dtype, *,
         tiles: Tuple[int, int] = None, brick_positions: int = None,
         stages: int = MMA_STAGES,
         target_blocks: int = MMA_TARGET_BLOCKS) -> Plan:
    """The kernel and split for a weight gradient of ``batch`` volumes
    ``vol`` with ``ci`` -> ``co`` channels. The keywords override the
    tensor-core choices (for measuring alternatives): block channel
    ``tiles`` (16 or 32 per side, at most two 16 x 16 slabs), positions per
    brick (default ``BRICK_POSITIONS`` per slab), bricks in flight, blocks
    to aim for.

    The defaults are the fastest of ``tools/dw_bench.py``'s grid at the
    flagship step's shapes on an H100: two slabs per block where the
    channels allow (a 32-wide tile on the side that is a multiple of 32, Co
    first), 256 positions per brick and slab, 16 blocks per SM."""
    kx, ky, kz = kernel_size
    positions = batch * math.prod(vol)
    tci, tco = tiles or ((16, 32) if co % 32 == 0 else
                         (32, 16) if ci % 32 == 0 else (16, 16))
    if tci not in (16, 32) or tco not in (16, 32) or tci * tco > 512:
        raise ValueError(f"tiles {(tci, tco)} are not one or two 16 x 16 "
                         "slabs")
    slabs = (tci // 16) * (tco // 16)
    brick_positions = brick_positions or BRICK_POSITIONS * slabs
    ry = min(ky, 2 * kz // slabs)  # threads <= 64 * kz, the launch bound
    if dtype not in (torch.bfloat16, torch.float16) or ci % tci \
            or co % tco or kz not in MMA_KZ:
        tiles = -(-ci // _tile(ci)) * -(-co // _tile(co))
        chunks, chunk_len = split(positions, kx * ky * kz, tiles)
        return Plan("simt", chunks, chunk_len)
    x, y, z = vol
    bz = min(_pow2(z), 32)
    by = min(_pow2(y), 8)
    bx = min(_pow2(x), max(1, brick_positions // (by * bz)))
    bb = min(_pow2(batch), 256, max(1, brick_positions // (bx * by * bz)))
    brick = [max(bb, 16 // (bx * by * bz)), bx, by, bz]  # >= 16 positions
    for axis in range(4):  # shrink to fit, batch first
        while (mma_smem((tci, tco), brick, ry, kz, stages) > MMA_SMEM
               and brick[axis] > 1 and math.prod(brick) > 16):
            brick[axis] //= 2
    p = Plan("narrow" if (tci, tco) == (ci, co) else "wide", 0, 0,
             (tci, tco), tuple(brick), ry, stages,
             mma_smem((tci, tco), brick, ry, kz, stages))
    bricks = p.bricks(batch, vol)
    want = -(-target_blocks // p.blocks_per_chunk(kernel_size, ci, co))
    chunks = max(1, min(bricks, want, MAX_CHUNKS))
    per_chunk = -(-bricks // chunks)
    return dataclasses.replace(p, chunks=-(-bricks // per_chunk),
                               per_chunk=per_chunk)


@functools.cache
def _kernel(entry: str):
    fn = getattr(build.load("dw_conv").lib, entry)
    if entry == "vnet_dw_conv":
        ints = [ctypes.c_int] * 11 + [ctypes.c_longlong]
    else:  # vnet_dw_conv_mma
        ints = [ctypes.c_int] * 20
    fn.argtypes = [ctypes.c_void_p] * 4 + ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dw_conv(x: torch.Tensor, g: torch.Tensor,
            kernel_size: Sequence[int]) -> torch.Tensor:
    """Weight gradient ``(Co, Ci, *kernel_size)`` float32 of a stride-1 SAME
    convolution with input ``x`` ``(B, Ci, X, Y, Z)`` and output gradient
    ``g`` ``(B, Co, X, Y, Z)``. CUDA tensors launch ``csrc/dw_conv.cu`` as
    :func:`plan` says (on channels-last copies where they are not
    channels-last already); CPU tensors take :func:`dw_conv_plain`."""
    _check(x, g, kernel_size)
    if x.device.type == "cpu":
        return dw_conv_plain(x, g, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ks = tuple(int(k) for k in kernel_size)
    cl = torch.channels_last_3d
    x = x.contiguous(memory_format=cl)
    g = g.contiguous(memory_format=cl)
    out = launch(x, g, ks, plan(x.shape[0], x.shape[2:], x.shape[1],
                                g.shape[1], ks, x.dtype))
    dw_conv.launches += 1
    return out


def launch(x: torch.Tensor, g: torch.Tensor, ks: Tuple[int, int, int],
           p: Plan) -> torch.Tensor:
    """Run ``csrc/dw_conv.cu`` on channels-last CUDA ``x`` and ``g`` with
    plan ``p`` (no launch count: :func:`dw_conv` is the entry point)."""
    cl = torch.channels_last_3d
    if not all(t.is_cuda and t.is_contiguous(memory_format=cl)
               for t in (x, g)):
        raise ValueError("launch takes channels-last CUDA tensors")
    b, ci, *vol = x.shape
    co = g.shape[1]
    if p.regime != "simt":  # 16-byte copies: realign a view that is not
        x, g = (t if t.data_ptr() % 16 == 0 else t.clone(memory_format=cl)
                for t in (x, g))
    partial = torch.empty(p.chunks * math.prod(ks) * ci * co,
                          dtype=torch.float32, device=x.device)
    out = torch.empty((co, ci) + ks, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                out.data_ptr(), _DTYPES[x.dtype], b, *vol, ci, co, *ks)
        if p.regime == "simt":
            err = _kernel("vnet_dw_conv")(*args, p.chunks, p.per_chunk,
                                          stream)
        else:
            err = _kernel("vnet_dw_conv_mma")(
                *args, *p.tiles, *p.brick, p.ry, p.stages, p.chunks,
                p.per_chunk, stream)
    if err != 0:
        raise RuntimeError(f"dw_conv launch failed ({p.regime}): CUDA error "
                           f"{err}")
    return out


dw_conv.launches = 0


class _ConvDw(torch.autograd.Function):
    """``F.conv3d(x, w, padding=lo)``, stride 1; backward: dx from
    ``aten.convolution_backward`` (cuDNN on the card, as JAX takes dx from
    XLA), dW from :func:`dw_conv` cast to the weight's dtype (as
    ``dw_conv.py:323`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.padding = padding
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, None, 1, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1, 1), ctx.padding, (1, 1, 1), False,
                (0, 0, 0), 1, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            dw = dw_conv(x, g, tuple(w.shape[2:])).to(w.dtype)
        return dx, dw, None


def conv3d_dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution (odd kernel, no bias) whose weight
    gradient is :func:`dw_conv`."""
    if any(k % 2 == 0 for k in w.shape[2:]):
        raise ValueError(f"DwImpl 'pallas' takes odd kernels only, got "
                         f"{tuple(w.shape[2:])}")
    return _ConvDw.apply(x, w, tuple((k - 1) // 2 for k in w.shape[2:]))
