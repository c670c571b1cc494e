"""The port's BatchNorm statistics, fused tail and row blend against the JAX
Pallas kernels.

On the CPU each wrapper runs its plain version; it is held against the JAX
kernel run in interpret mode, as ``tests/test_pallas.py`` runs it, on the
same seeded numpy inputs. Tolerances: float32 sums at ``rtol = 1e-5`` (and
``atol = 1e-5 * sum|terms|`` per channel, for sums near zero); the float32
tail at ``rtol = 1e-6``; the bfloat16 tail within one bf16 ulp of its
operands or ``rtol = 1e-2`` (XLA may keep bf16 intermediates in float32).
The row blend's tile plan is checked against a naive planner, and
replaying the segments in the kernel's order (tile by tile, each row's
segments in index order) must equal the sequential loop bitwise. The CUDA
kernels are held against the plain versions on the card
(``tests/test_torch_cuda_fused.py``, which holds the inputs shared with this
module, and ``chip_smoke.py`` phases 9-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_fused import ROW_CASES, _row_inputs, _tail_inputs
from vnet_tpu.ops.pallas import blend_accumulate_rows as jax_rows
from vnet_tpu.ops.pallas import fused_bias_prelu_residual as jax_tail
from vnet_tpu.ops.pallas.fused import bn_grad_stats as jax_grad_stats
from vnet_tpu.ops.pallas.fused import bn_stats as jax_stats
from vnet_tpu_torch.ops.blend import (blend_accumulate_rows,
                                      blend_accumulate_rows_plain,
                                      plan_row_tiles, row_tile)
from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_stats,
                                      bn_stats_plain,
                                      fused_bias_prelu_residual, split_rows)

BF16_ULP = 2.0 ** -7  # bf16 spacing relative to a value's binade


def _sum_close(got, ref, terms):
    """float32 sums at rtol 1e-5, atol 1e-5 * sum|terms| per channel."""
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(terms).reshape(
                                   -1, terms.shape[-1]).sum(0).max())


STATS_SHAPES = {"f32_4x8x8x32": ((4, 8, 8, 32), torch.float32),
                "bf16_6x5x16": ((6, 5, 16), torch.bfloat16),
                "f32_output_norm_c3": ((3, 7, 5, 3), torch.float32)}


@pytest.mark.parametrize("name", sorted(STATS_SHAPES))
def test_bn_stats_plain_matches_jax_interpret(name, rng):
    shape, dtype = STATS_SHAPES[name]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    xn = x.float().numpy()
    s_ref, sq_ref = jax_stats(jnp.asarray(xn).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        interpret=True)
    before = bn_stats.launches
    s, sq = bn_stats(x)
    assert bn_stats.launches == before  # CPU: no launch
    assert s.dtype == sq.dtype == torch.float32 and s.shape == (shape[-1],)
    _sum_close(s.numpy(), np.asarray(s_ref), xn)
    _sum_close(sq.numpy(), np.asarray(sq_ref), xn * xn)


@pytest.mark.parametrize("name", sorted(STATS_SHAPES))
def test_bn_grad_stats_plain_matches_jax_interpret(name, rng):
    shape, dtype = STATS_SHAPES[name]
    c = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    mean = rng.normal(size=(c,)).astype(np.float32) * 0.1
    inv = (rng.random(c) + 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    sdy_ref, sdx_ref = jax_grad_stats(
        jnp.asarray(dy.float().numpy()).astype(jdt),
        jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(mean),
        jnp.asarray(inv), interpret=True)
    sdy, sdx = bn_grad_stats(dy, x, torch.from_numpy(mean),
                             torch.from_numpy(inv))
    dyn = dy.float().numpy()
    xhat = (x.float().numpy() - mean) * inv
    _sum_close(sdy.numpy(), np.asarray(sdy_ref), dyn)
    _sum_close(sdx.numpy(), np.asarray(sdx_ref), dyn * xhat)


def test_bn_stats_accept_strided_input(rng):
    """A non-contiguous ``(..., C)`` tensor reduces like its copy."""
    x = torch.from_numpy(rng.normal(size=(4, 6, 10)).astype(np.float32))
    view = x[:, ::2, :8]
    for got, ref in zip(bn_stats(view), bn_stats_plain(view.contiguous())):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_split_rows_covers_every_row():
    for rows, c, vec, size in ((25_165_824, 16, 1, 2), (3, 3, 0, 4),
                               (6_291_456, 128, 1, 2), (1, 4096, 0, 4)):
        chunks, chunk_rows = split_rows(rows, c, vec, size)
        assert chunks >= 1 and chunks * chunk_rows >= rows
        assert (chunks - 1) * chunk_rows < rows  # no empty chunk


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (5, 7, 3)])
def test_tail_plain_matches_jax_interpret_f32(shape, rng):
    x, res, bias, alpha = _tail_inputs(rng, shape, torch.float32)
    ref = jax_tail(*(jnp.asarray(t.numpy()) for t in (x, res, bias, alpha)),
                   interpret=True)
    before = fused_bias_prelu_residual.launches
    got = fused_bias_prelu_residual(x, res, bias, alpha)
    assert fused_bias_prelu_residual.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    y = x.numpy() + bias.numpy() + res.numpy()  # test_pallas.py's reference
    np.testing.assert_allclose(got.numpy(), np.maximum(y, 0)
                               + alpha.numpy() * np.minimum(y, 0), rtol=1e-6)


def test_tail_plain_matches_jax_interpret_bf16(rng):
    x, res, bias, alpha = _tail_inputs(rng, (2, 8, 8, 16), torch.bfloat16)
    ref = jax_tail(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                     for t in (x, res, bias, alpha)), interpret=True)
    got = fused_bias_prelu_residual(x, res, bias, alpha)
    assert got.dtype == torch.bfloat16
    got, ref = got.float().numpy(), np.asarray(ref).astype(np.float32)
    scale = (np.abs(x.float().numpy()) + np.abs(bias.float().numpy())
             + np.abs(res.float().numpy()))
    err = np.abs(got - ref)
    assert np.all((err <= BF16_ULP * scale) | (err <= 1e-2 * np.abs(ref)))


def test_tail_rounds_after_every_operation():
    """bf16: ``(x + b) + r`` rounds ``x + b`` first, so 256 + 1 + 1 stays
    256 where one rounding of the exact sum would give 258."""
    x = torch.tensor([[256.0]], dtype=torch.bfloat16)
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    out = fused_bias_prelu_residual(x, torch.ones_like(x), one, one)
    assert out.item() == 256.0
    neg = fused_bias_prelu_residual(-x, -torch.ones_like(x), -one,
                                    torch.tensor([0.5], dtype=torch.bfloat16))
    assert neg.item() == -128.0


TAIL_DTYPES = {"f32": (torch.float32, jnp.float32),
               "bf16": (torch.bfloat16, jnp.bfloat16),
               "f16": (torch.float16, jnp.float16)}


@pytest.mark.parametrize("x_dt,bias_dt,alpha_dt", [
    ("f32", "bf16", "bf16"), ("f32", "f16", "f32"), ("bf16", "f32", "f32"),
    ("bf16", "bf16", "f32"), ("bf16", "f16", "bf16"), ("f16", "f16", "f32")])
def test_tail_mixed_dtypes_follow_jax(x_dt, bias_dt, alpha_dt, rng):
    """``bias`` and ``alpha`` of another dtype than ``x``: where they
    promote with ``x`` to ``x``'s dtype the result matches the JAX kernel;
    where the promoted result is wider, the JAX kernel refuses to store it
    into its ``x``-typed output, and the port refuses too."""
    shape = (3, 5, 8)
    arrays = [rng.normal(size=shape), rng.normal(size=shape),
              rng.normal(size=(8,)), np.full((8,), 0.25)]
    dts = [TAIL_DTYPES[k] for k in (x_dt, x_dt, bias_dt, alpha_dt)]
    jargs = [jnp.asarray(a.astype(np.float32)).astype(jd)
             for a, (_, jd) in zip(arrays, dts)]
    targs = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
             for j, (td, _) in zip(jargs, dts)]
    if x_dt != "f32":
        with pytest.raises(ValueError):
            jax_tail(*jargs, interpret=True)
        with pytest.raises(TypeError, match="does not promote"):
            fused_bias_prelu_residual(*targs)
        return
    ref = jax_tail(*jargs, interpret=True)
    got = fused_bias_prelu_residual(*targs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("kind", ["dtype", "shape", "bias", "device"])
def test_tail_rejects_bad_arguments(kind, rng):
    x, res, bias, alpha = _tail_inputs(rng, (2, 4, 6), torch.float32)
    if kind == "dtype":
        res = res.double()
    elif kind == "shape":
        res = res[:1]
    elif kind == "bias":
        bias = bias[:3]
    else:
        alpha = alpha.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fused_bias_prelu_residual(x, res, bias, alpha)


def test_wrappers_never_fall_back_off_the_cpu():
    x = torch.empty((4, 8), device="meta")
    v = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bn_stats(x)
    with pytest.raises(ValueError, match="unsupported device"):
        bn_grad_stats(x, x, v, v)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_bias_prelu_residual(x, x, v, v)
    acc = torch.empty((16, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        blend_accumulate_rows(acc, torch.empty((16, 1), device="meta"),
                              torch.empty((1, 4, 2), device="meta"),
                              torch.empty((4, 1), device="meta"),
                              torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_rows_plain_matches_jax_interpret(name, rng):
    acc, weight, probs, window, starts = _row_inputs(rng, *ROW_CASES[name])
    ref_acc, ref_w = jax_rows(*(jnp.asarray(a) for a in (
        acc, weight, probs, window, starts)), interpret=True)
    before = blend_accumulate_rows.launches
    acc_t, w_t = torch.from_numpy(acc.copy()), torch.from_numpy(weight.copy())
    out_acc, out_w = blend_accumulate_rows(
        acc_t, w_t, torch.from_numpy(probs), torch.from_numpy(window),
        torch.from_numpy(starts))
    assert out_acc is acc_t and out_w is w_t  # in place
    assert blend_accumulate_rows.launches == before
    np.testing.assert_allclose(out_acc.numpy(), np.asarray(ref_acc),
                               rtol=1e-5)
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=1e-5)


def _naive_tiles(starts, r, tile, num_rows):
    return [[i for i, s in enumerate(starts)
             if s < (t + 1) * tile and s + r > t * tile]
            for t in range(-(-num_rows // tile))]


def _tile_lists(tile_ptr, seg_idx):
    ptr = tile_ptr.tolist()
    return [seg_idx[lo:hi].tolist() for lo, hi in zip(ptr[:-1], ptr[1:])]


@pytest.mark.parametrize("seed,n,span,r", [(0, 200, 50, 7), (1, 300, 1000, 5),
                                            (2, 64, 4, 3), (3, 1, 10, 4),
                                            (4, 40, 400, 1),
                                            (5, 50, 2000, 300)])
def test_row_tile_plan_matches_naive_planner(seed, n, span, r):
    """Each tile lists the segments that meet it in increasing index, at
    the kernel's tile (a segment of r > 256 rows grows it) and at a tile
    as short as the segments, where most segments meet two tiles."""
    starts = np.random.default_rng(seed).integers(0, span, size=n).astype(
        np.int32)
    num_rows = span + r
    for tile in (row_tile(r), max(r, 8)):
        tile_ptr, seg_idx = plan_row_tiles(torch.from_numpy(starts), r, tile,
                                           num_rows)
        assert tile_ptr.dtype == seg_idx.dtype == torch.int32
        assert _tile_lists(tile_ptr, seg_idx) == _naive_tiles(
            starts, r, tile, num_rows)


def test_row_tile_grows_with_the_segments():
    assert [row_tile(r) for r in (1, 32, 256, 257, 300, 1000, 1025)] == [
        256, 256, 256, 512, 512, 1024, 2048]
    with pytest.raises(ValueError, match="shorter than the segments"):
        plan_row_tiles(torch.zeros(1, dtype=torch.int32), 300, 256, 400)


def test_row_tile_plan_of_no_segments():
    tile_ptr, seg_idx = plan_row_tiles(torch.zeros(0, dtype=torch.int32), 4,
                                       256, 600)
    assert tile_ptr.tolist() == [0, 0, 0, 0] and seg_idx.numel() == 0


@pytest.mark.parametrize("tile", ["kernel", "short"])
@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_tile_replay_equals_sequential_loop(name, tile, rng):
    """What the kernel does, on the CPU: tile by tile, each row adds the
    segments of its tile's list that cover it, in list order, one float32
    rounding after the product and one after the sum; that gives the
    sequential loop's bits."""
    acc, weight, probs, window, starts = _row_inputs(rng, *ROW_CASES[name])
    r = probs.shape[1]
    size = row_tile(r) if tile == "kernel" else r + 1
    exp_acc, exp_w = acc.copy(), weight.copy()
    blend_accumulate_rows_plain(torch.from_numpy(exp_acc),
                                torch.from_numpy(exp_w),
                                torch.from_numpy(probs),
                                torch.from_numpy(window),
                                torch.from_numpy(starts))
    tile_ptr, seg_idx = plan_row_tiles(torch.from_numpy(starts), r, size,
                                       acc.shape[0])
    for t, segs in enumerate(_tile_lists(tile_ptr, seg_idx)):
        for row in range(t * size, min((t + 1) * size, acc.shape[0])):
            for i in segs:
                o = row - starts[i]
                if 0 <= o < r:
                    acc[row] += probs[i, o] * window[o]
                    weight[row] += window[o]
    np.testing.assert_array_equal(acc, exp_acc)
    np.testing.assert_array_equal(weight, exp_w)


@pytest.mark.parametrize("kind", ["dtype", "window", "starts_dtype",
                                  "starts_range", "starts_negative"])
def test_rows_reject_bad_arguments(kind, rng):
    acc, weight, probs, window, starts = _row_inputs(
        rng, *ROW_CASES["overlap_dup"])
    args = [torch.from_numpy(a) for a in (acc, weight, probs, window, starts)]
    if kind == "dtype":
        args[2] = args[2].double()
    elif kind == "window":
        args[3] = args[3][:-1]
    elif kind == "starts_dtype":
        args[4] = args[4].long()
    elif kind == "starts_range":
        args[4][5] = acc.shape[0] - probs.shape[1] + 1
    else:
        args[4][0] = -1
    with pytest.raises((TypeError, ValueError)):
        blend_accumulate_rows(*args)
