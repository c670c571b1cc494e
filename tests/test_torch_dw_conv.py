"""The port's weight gradient (``ops/dw_conv.py``) against the JAX
package's.

The plain version runs here: against the JAX Pallas kernel in interpret
mode at a lane-aligned shape of ``tests/test_pallas_dw.py``, against the
JAX package's XLA formulation (``_dw_xla``) at the V-Net's narrow shapes
(5^3 with Ci != Co, 1^3 16 -> 3), and, through the autograd Function,
against torch autograd of ``F.conv3d``. All in float32; the sums run in
another order on each side, so values compare at ``rtol = 1e-4`` and
``atol = 1e-4 * max|dW|``. The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda_dw_conv.py`` and
``chip_smoke.py`` phase 6),
and the planner that splits its work is checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vnet_tpu.ops.conv_vjp import same_pads
from vnet_tpu.ops.pallas.dw_conv import _dw_xla, dw_conv_pallas
from vnet_tpu_torch.models.layers import SpatialConv
from vnet_tpu_torch.tools.profile_step import group_of
from vnet_tpu_torch.ops.dw_conv import (MAX_CHUNKS, MMA_SMEM, conv3d_dw,
                                        dw_conv, dw_conv_plain, launch,
                                        mma_smem, plan, split)

RTOL = 1e-4


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def _pair(rng, b, x, y, z, ci, co):
    xn = rng.normal(size=(b, x, y, z, ci)).astype(np.float32)
    gn = rng.normal(size=(b, x, y, z, co)).astype(np.float32)
    xt = torch.from_numpy(xn).permute(0, 4, 1, 2, 3)
    gt = torch.from_numpy(gn).permute(0, 4, 1, 2, 3)
    return xn, gn, xt, gt


def _to_dhwio(dw: torch.Tensor) -> np.ndarray:
    """Port ``(Co, Ci, k...)`` -> JAX ``(k..., Ci, Co)``."""
    return dw.permute(2, 3, 4, 1, 0).numpy()


def test_plain_matches_jax_pallas_interpret(rng):
    xn, gn, xt, gt = _pair(rng, 2, 8, 8, 8, 128, 128)
    pads = same_pads((3, 3, 3))
    ref = np.asarray(dw_conv_pallas(jnp.asarray(xn), jnp.asarray(gn),
                                    (3, 3, 3), pads, interpret=True))
    _close(_to_dhwio(dw_conv_plain(xt, gt, (3, 3, 3))), ref)


@pytest.mark.parametrize("shape,k", [
    ((2, 8, 6, 4, 8, 4), 5),     # 5^3, decoder-like 2n -> n
    ((2, 6, 6, 6, 4, 8), 5),     # 5^3, Ci < Co
    ((2, 8, 8, 8, 16, 3), 1),    # the 1^3 output convolution
])
def test_plain_matches_jax_xla_formulation(shape, k, rng):
    b, x, y, z, ci, co = shape
    xn, gn, xt, gt = _pair(rng, b, x, y, z, ci, co)
    ref = np.asarray(_dw_xla(jnp.asarray(xn), jnp.asarray(gn),
                             same_pads((k,) * 3), 3))
    _close(_to_dhwio(dw_conv_plain(xt, gt, (k,) * 3)), ref)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_function_matches_torch_autograd(k, rng):
    _, _, xt, gt = _pair(rng, 2, 6, 5, 7, 3, 4)
    x = xt.clone().requires_grad_()
    w = torch.from_numpy(rng.normal(size=(4, 3, k, k, k)).astype(np.float32)
                         ).requires_grad_()
    y = conv3d_dw(x, w)
    ref = F.conv3d(x, w, None, 1, (k - 1) // 2)
    assert torch.equal(y, ref)
    dx, dw = torch.autograd.grad(y, (x, w), gt)
    rdx, rdw = torch.autograd.grad(ref, (x, w), gt)
    assert torch.equal(dx, rdx)
    _close(dw.numpy(), rdw.numpy())


def test_spatial_conv_pallas_adds_bias_outside(rng):
    """``dw_impl="pallas"`` and ``"xla"`` give the same convolution and
    gradients (bias added after the Function, as JAX adds it)."""
    _, _, xt, gt = _pair(rng, 2, 6, 6, 6, 3, 5)
    outs = []
    for impl in ("xla", "pallas"):
        conv = SpatialConv(3, 5, (5, 5, 5), dw_impl=impl,
                           generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            conv.bias.uniform_(-1, 1, generator=torch.Generator()
                               .manual_seed(2))
        x = xt.clone().requires_grad_()
        y = conv(x)
        outs.append((y,) + torch.autograd.grad(y, (x, conv.weight,
                                                    conv.bias), gt))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=RTOL, atol=RTOL * a.abs().max().item())


def test_even_kernel_and_bad_impl_raise():
    with pytest.raises(ValueError, match="odd"):
        conv3d_dw(torch.zeros(1, 2, 4, 4, 4), torch.zeros(3, 2, 2, 2, 2))
    with pytest.raises(ValueError, match="dw_impl"):
        SpatialConv(2, 3, (5, 5, 5), dw_impl="cudnn")


def test_split_covers_every_position():
    for positions, offsets, tiles in [(96 * 64 ** 3, 125, 1), (6144, 125, 16),
                                      (7, 1, 1), (96 * 64 ** 3, 1, 1)]:
        chunks, chunk_len = split(positions, offsets, tiles)
        assert 1 <= chunks <= 65535 and chunk_len % 64 == 0
        assert (chunks - 1) * chunk_len < positions <= chunks * chunk_len


def test_cpu_takes_plain_and_counts_no_launch(rng):
    _, _, xt, gt = _pair(rng, 1, 4, 4, 4, 2, 2)
    before = dw_conv.launches
    dw_conv(xt, gt, (3, 3, 3))
    assert dw_conv.launches == before


def test_wrapper_never_falls_back_off_the_cpu():
    x = torch.empty(1, 2, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dw_conv(x, x, (3, 3, 3))


def test_launch_takes_channels_last_cuda_tensors_only(rng):
    _, _, xt, gt = _pair(rng, 1, 4, 4, 4, 16, 16)
    p = plan(1, (4, 4, 4), 16, 16, (3, 3, 3), torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last CUDA"):
        launch(xt.bfloat16(), gt.bfloat16(), (3, 3, 3), p)


# the ten distinct stride-1 weight gradients of the flagship step, batch 96
FLAGSHIP_DW = [(16, 16, 64, 5), (32, 16, 64, 5), (32, 32, 32, 5),
               (64, 32, 32, 5), (64, 64, 16, 5), (128, 64, 16, 5),
               (128, 128, 8, 5), (256, 128, 8, 5), (256, 256, 4, 5),
               (16, 3, 64, 1)]


@pytest.mark.parametrize("batch,vol,ci,co,k", [
    (96, (s,) * 3, ci, co, k) for ci, co, s, k in FLAGSHIP_DW] + [
    (3, (9, 11, 13), 16, 16, 5), (2, (7, 5, 9), 64, 32, 5),
    (1, (1, 1, 1), 16, 16, 7), (1000, (1, 1, 1), 32, 16, 3),
    (2, (12, 10, 16), 16, 32, 3), (2, (10, 10, 10), 32, 16, 1)])
def test_plan_covers_every_brick(batch, vol, ci, co, k):
    """Every brick of the volume falls in exactly one chunk, and the plan
    stays inside the kernel's limits (``vnet_dw_conv_mma`` refuses it
    otherwise)."""
    p = plan(batch, vol, ci, co, (k,) * 3, torch.bfloat16)
    if p.regime == "simt":
        positions = batch * int(np.prod(vol))
        assert (p.chunks - 1) * p.per_chunk < positions
        assert positions <= p.chunks * p.per_chunk
        return
    bricks = p.bricks(batch, vol)
    assert 1 <= p.chunks <= MAX_CHUNKS
    assert (p.chunks - 1) * p.per_chunk < bricks <= p.chunks * p.per_chunk
    positions = int(np.prod(p.brick))
    assert positions % 16 == 0 and positions <= 4096
    assert max(p.brick[:2]) <= 256  # TMA box extents
    assert p.smem == mma_smem(p.tiles, p.brick, p.ry, k, p.stages)
    assert p.smem <= MMA_SMEM
    assert ci % p.tiles[0] == 0 and co % p.tiles[1] == 0
    assert 1 <= p.ry <= k and p.threads() <= 64 * k  # the launch bound


@pytest.mark.parametrize("ci,co,dtype,regime,tiles", [
    (16, 16, torch.bfloat16, "narrow", (16, 16)),
    (32, 16, torch.bfloat16, "narrow", (32, 16)),
    (16, 32, torch.float16, "narrow", (16, 32)),
    (32, 32, torch.bfloat16, "wide", (16, 32)),
    (256, 128, torch.float16, "wide", (16, 32)),
    (48, 16, torch.bfloat16, "wide", (16, 16)),
    (16, 3, torch.bfloat16, "simt", (0, 0)),
    (16, 16, torch.float32, "simt", (0, 0)),
])
def test_plan_regime(ci, co, dtype, regime, tiles):
    """bf16 and f16 with channels in multiples of 16 take tensor cores
    (narrow where one block holds every channel pair); float32 and other
    channel counts take the CUDA-core kernel."""
    p = plan(4, (8, 8, 8), ci, co, (5, 5, 5), dtype)
    assert (p.regime, p.tiles) == (regime, tiles)


def test_plan_refuses_other_tiles_and_kernel_depths():
    with pytest.raises(ValueError, match="slabs"):
        plan(4, (8, 8, 8), 32, 32, (5, 5, 5), torch.bfloat16, tiles=(32, 32))
    assert plan(4, (8, 8, 8), 16, 16, (5, 5, 9),
                torch.bfloat16).regime == "simt"


def test_mma_smem_counts_every_stage():
    # x box 1 x 2 x (8 + 4) x (32 + 4) rows of 48 bytes, g brick 512 rows
    # of 48 bytes, 4 bytes of row table per position, 8 per barrier
    x_bytes, g_bytes = 2 * 12 * 36 * 48, 512 * 48
    assert mma_smem((16, 16), (1, 2, 8, 32), 5, 5, 2) == \
        2 * (x_bytes + g_bytes + 8) + 4 * 512
    assert mma_smem((16, 16), (1, 2, 8, 32), 5, 5, 3) == \
        3 * (x_bytes + g_bytes + 8) + 4 * 512


@pytest.mark.parametrize("name", [
    "void dw_mma_kernel<__nv_bfloat16, 5>(CUtensorMap, CUtensorMap, float*, "
    "MmaArgs)",
    "void dw_partial_kernel<float>(float const*, float const*, float*, int)",
    "dw_reduce_kernel(float const*, float*, int, int, int, int)"])
def test_profile_step_counts_every_dw_kernel(name):
    assert group_of(name) == "dW kernel"
