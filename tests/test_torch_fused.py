"""The port's BatchNorm statistics, fused tail and row blend against the JAX
Pallas kernels.

On the CPU each wrapper runs its plain version; it is held against the JAX
kernel run in interpret mode, as ``tests/test_pallas.py`` runs it, on the
same seeded numpy inputs. Tolerances: float32 sums at ``rtol = 1e-5`` (and
``atol = 1e-5 * sum|terms|`` per channel, for sums near zero); the float32
tail at ``rtol = 1e-6``; the bfloat16 tail within one bf16 ulp of its
operands or ``rtol = 1e-2`` (XLA may keep bf16 intermediates in float32).
The row blend's overlap levels are checked against a naive loop, and
replaying the segments level by level must equal the sequential loop
bitwise. The CUDA kernels are held against the plain versions on the card
(``cuda`` tests below and ``chip_smoke.py`` phases 9-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.ops.pallas import blend_accumulate_rows as jax_rows
from vnet_tpu.ops.pallas import fused_bias_prelu_residual as jax_tail
from vnet_tpu.ops.pallas.fused import bn_grad_stats as jax_grad_stats
from vnet_tpu.ops.pallas.fused import bn_stats as jax_stats
from vnet_tpu_torch.ops import blend, build, fused
from vnet_tpu_torch.ops.blend import (blend_accumulate_rows,
                                      blend_accumulate_rows_plain, plan_rows,
                                      row_levels)
from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_grad_stats_plain,
                                      bn_stats, bn_stats_plain,
                                      fused_bias_prelu_residual,
                                      fused_bias_prelu_residual_plain,
                                      split_rows)

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


def _tail_inputs(rng, shape, dtype):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    alpha = np.full((c,), 0.1, np.float32)
    alpha[::2] = 0.25
    conv = (lambda a: torch.from_numpy(a).to(dtype))
    return [conv(a) for a in (x, res, bias, alpha)]


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


ROW_CASES = {
    # test_pallas.py's segments
    "pallas_test": (64, 3, 8, [0, 8, 4, 40, 56]),
    # overlapping and duplicated starts, the last segment flush with R
    "overlap_dup": (61, 2, 7, [0, 3, 3, 10, 5, 54, 3, 0, 50, 54]),
}


def _row_inputs(rng, big_r, c, r, starts):
    n = len(starts)
    acc = rng.random((big_r, c)).astype(np.float32)
    weight = rng.random((big_r, 1)).astype(np.float32)
    probs = rng.random((n, r, c)).astype(np.float32)
    window = (rng.random((r, 1)) + 0.5).astype(np.float32)
    return acc, weight, probs, window, np.asarray(starts, np.int32)


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


def _naive_levels(starts, r):
    level = np.zeros(len(starts), np.int64)
    for i, s in enumerate(starts):
        level[i] = 1 + max((level[j] for j in range(i)
                            if abs(int(s) - int(starts[j])) < r), default=0)
    return level


@pytest.mark.parametrize("seed,n,span,r", [(0, 200, 50, 7), (1, 300, 1000, 5),
                                            (2, 64, 4, 3), (3, 1, 10, 4),
                                            (4, 40, 400, 1)])
def test_row_levels_match_naive_loop(seed, n, span, r):
    starts = np.random.default_rng(seed).integers(0, span, size=n)
    np.testing.assert_array_equal(row_levels(starts, r),
                                  _naive_levels(starts, r))


def test_row_levels_of_no_segments():
    assert row_levels(np.zeros(0, np.int32), 4).shape == (0,)


@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_level_replay_equals_sequential_loop(name, rng):
    """What the kernel does, on the CPU: the segments level by level (each
    level in reverse, to show order inside a level does not matter) give the
    sequential loop's bits."""
    acc, weight, probs, window, starts = _row_inputs(rng, *ROW_CASES[name])
    r = probs.shape[1]
    order, bounds = plan_rows(starts, r)
    assert bounds[0] == 0 and bounds[-1] == len(starts)
    exp_acc, exp_w = acc.copy(), weight.copy()
    blend_accumulate_rows_plain(torch.from_numpy(exp_acc),
                                torch.from_numpy(exp_w),
                                torch.from_numpy(probs),
                                torch.from_numpy(window),
                                torch.from_numpy(starts))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        level = order[lo:hi][::-1]
        s = starts[level]
        assert np.all(np.abs(s[:, None] - s[None, :])[~np.eye(len(s),
                      dtype=bool)] >= r)  # no two of a level overlap
        for i in level:
            acc[starts[i]:starts[i] + r] += probs[i] * window
            weight[starts[i]:starts[i] + r] += window
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(4, 9, 16), (3, 7, 5, 3), (2, 3, 2056)])
def test_bn_kernels_match_plain_on_card(shape, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    c = shape[-1]
    mean = torch.randn(c, generator=gen, device=cuda_device) * 0.1
    inv = torch.rand(c, generator=gen, device=cuda_device) + 0.5
    before = (bn_stats.launches, bn_grad_stats.launches)
    got = bn_stats(x) + bn_grad_stats(dy, x, mean, inv)
    ref = bn_stats_plain(x) + bn_grad_stats_plain(dy, x, mean, inv)
    again = bn_stats(x) + bn_grad_stats(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (bn_stats.launches, bn_grad_stats.launches) == (before[0] + 2,
                                                           before[1] + 2)
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean) * inv
    for k, terms in enumerate((xf, xf * xf, dyf, dyf * xhat)):
        bound = 1e-5 * terms.abs().reshape(-1, c).sum(0)
        assert bool(((got[k] - ref[k]).abs() <= bound).all())
        assert torch.equal(got[k], again[k])  # reproducible


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (5, 7, 3)])
def test_tail_kernel_equals_plain_on_card(shape, dtype, rng, cuda_device):
    args = [t.to(cuda_device) for t in _tail_inputs(rng, shape, dtype)]
    before = fused_bias_prelu_residual.launches
    got = fused_bias_prelu_residual(*args)
    ref = fused_bias_prelu_residual_plain(*args)
    torch.cuda.synchronize()
    assert fused_bias_prelu_residual.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_rows_kernel_equals_plain_on_card(name, rng, cuda_device):
    acc, weight, probs, window, starts = _row_inputs(rng, *ROW_CASES[name])
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (acc, weight, probs, window)]
    ref_acc, ref_w = dev[0].clone(), dev[1].clone()
    st = torch.from_numpy(starts)
    before = blend_accumulate_rows.launches
    blend_accumulate_rows(*dev, st)
    blend_accumulate_rows_plain(ref_acc, ref_w, dev[2], dev[3], st)
    torch.cuda.synchronize()
    depth = int(row_levels(starts, probs.shape[1]).max())
    assert blend_accumulate_rows.launches == before + depth
    assert torch.equal(dev[0], ref_acc) and torch.equal(dev[1], ref_w)


@pytest.mark.cuda
def test_cuda_tensor_raises_when_the_library_cannot_load(monkeypatch,
                                                         cuda_device):
    """No fallback to the plain version on the card."""
    def refuse(name):
        raise build.KernelBuildError(f"refused to build {name}")

    monkeypatch.setattr(build, "load", refuse)
    cached = (fused._lib, fused._tail_kernel, blend._rows_kernel)
    for fn in cached:
        fn.cache_clear()
    x = torch.ones((4, 8), device=cuda_device)
    v = torch.ones((8,), device=cuda_device)
    try:
        with pytest.raises(build.KernelBuildError):
            bn_stats(x)
        with pytest.raises(build.KernelBuildError):
            bn_grad_stats(x, x, v, v)
        with pytest.raises(build.KernelBuildError):
            fused_bias_prelu_residual(x, x, v, v)
        with pytest.raises(build.KernelBuildError):
            blend_accumulate_rows(x, v.reshape(8, 1)[:4], x[None], v[:4, None],
                                  torch.zeros(1, dtype=torch.int32))
    finally:
        for fn in cached:
            fn.cache_clear()
