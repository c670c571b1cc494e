"""The port's dropout (``ops/dropout.py``) against the JAX package's.

The random streams differ by design (the port's is Philox4x32-10, JAX's
kernel uses the TPU's generator, flax threefry), so the tests hold the
port to the JAX formulas for threshold and scale, to the survivors' values
bit for bit (``xla``: flax's ``inputs / keep_prob``), to the keep
probability within 5 standard deviations at 2^20 elements or more, to
``E[out] = x``, and to the mask properties the training step relies on
(with a counter base, a data-parallel rank's mask is its rows of the global
batch's). The
plain version runs here; the CUDA kernel is held bitwise against it on the
card (``tests/test_torch_cuda_dropout.py`` and ``chip_smoke.py``).
"""

import fractions
import math

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from vnet_tpu.ops.pallas.dropout import pallas_dropout
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.ops.dropout import (dropout, dropout_apply,
                                        dropout_params, dropout_plain,
                                        keep_mask, philox4x32_10)

RATES = (0.01, 0.1, 0.3, 0.5, 0.9)


def _jax_thresholds(rate):
    """The JAX package's formulas (dropout.py:42,49 and layers.py:704-709)."""
    keep = 1.0 - rate
    thr = min(int(round(keep * 4294967296.0)), 4294967295)
    t = min(max(int(round(keep * 256.0)), 1), 255)
    return {"pallas": (thr, 1.0 / keep, False), "xla": (thr, keep, True),
            "bits8": (t << 24, 256.0 / t, False)}


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("impl", ["pallas", "bits8", "xla"])
def test_threshold_and_scale_equal_jax_formulas(impl, rate):
    assert dropout_params(rate, impl) == _jax_thresholds(rate)[impl]


def test_philox_known_answer():
    """Random123's published Philox4x32-10 test vector (counter 0, key 0)."""
    words = philox4x32_10(torch.zeros(1, dtype=torch.int64), 0, 0)[0]
    assert [hex(int(w)) for w in words] == [
        "0x6627e8d5", "0xe169c58d", "0xbc57ac4c", "0x9b00dbd8"]


@pytest.mark.parametrize("impl,rate", [("pallas", 0.01), ("pallas", 0.3),
                                       ("bits8", 0.3), ("xla", 0.5)])
def test_keep_fraction_within_5_sigma(impl, rate):
    n = 1 << 20
    thr, _, _ = dropout_params(rate, impl)
    p = thr / 2.0 ** 32
    kept = keep_mask(n, 1234, 5, thr).sum().item()
    assert abs(kept - n * p) < 5 * math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("impl", ["pallas", "bits8"])
def test_mean_is_preserved(impl):
    """``E[out] = x``: survivors are scaled by 1 / P(keep) exactly."""
    x = torch.full((1 << 20,), 3.0)
    thr, scale, divide = dropout_params(0.3, impl)
    out = dropout_apply(x, 77, 1, thr, scale, divide)
    p = thr / 2.0 ** 32
    assert scale * p == pytest.approx(1.0, abs=2.0 ** -31)
    sigma = 3.0 * scale * math.sqrt(p * (1 - p) / x.numel())
    assert abs(out.mean().item() - 3.0) < 5 * sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_survivors_scaled_in_dtype_like_jax(dtype, rng):
    """Survivors equal the JAX kernel's output, bit for bit: ``x *
    dtype(1 / keep)`` rounded once. The JAX kernel runs in interpret mode,
    whose stubbed generator keeps every element, so its output is the
    scaled input everywhere."""
    xn = rng.normal(size=(4, 5, 6, 7, 3)).astype(np.float32)  # JAX layout
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    expect = np.array(pallas_dropout(jnp.asarray(xn, jdtype), 9, 0.2,
                                       True).astype(jnp.float32))
    x = torch.from_numpy(xn).permute(0, 4, 1, 2, 3).to(dtype)
    out = dropout_apply(x, 9, 2, *dropout_params(0.2, "pallas"))
    out = out.permute(0, 2, 3, 4, 1).float()
    expect = torch.from_numpy(expect)
    kept = out != 0
    assert 0.7 < kept.float().mean().item() < 0.9
    assert torch.equal(out[kept], expect[kept])


XLA_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
              "f16": (torch.float16, jnp.float16),
              "f32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("rate", [0.01, 0.3])
@pytest.mark.parametrize("name", sorted(XLA_DTYPES))
def test_xla_survivors_equal_flax_division(name, rate, rng):
    """``xla`` survivors equal flax's ``inputs / keep_prob`` bit for bit:
    JAX rounds ``keep_prob`` to the array's dtype and divides once, which
    differs from ``x * dtype(1 / keep)`` (bf16 at rate 0.01: 0.98828125,
    and most survivors differ by an ulp) and, in float32, from ``x *
    f32(1 / keep)`` by an ulp at some elements. The survivors of flax's own
    ``nn.Dropout`` are held to the same values."""
    tdt, jdt = XLA_DTYPES[name]
    xn = (rng.normal(size=(2, 16, 8, 8, 4)) * 50.0).astype(np.float32)
    xj = jnp.asarray(xn).astype(jdt)
    keep_prob = 1.0 - rate
    expect = torch.from_numpy(np.array((xj / keep_prob).astype(jnp.float32)))
    flax_out = torch.from_numpy(np.array(flax_nn.Dropout(rate).apply(
        {}, xj, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(3)}).astype(jnp.float32)))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    out = dropout_apply(x.permute(0, 4, 1, 2, 3), 5, 1,
                        *dropout_params(rate, "xla"))
    out = out.permute(0, 2, 3, 4, 1).float()
    kept = out != 0
    assert torch.equal(out[kept], expect[kept])
    both = kept & (flax_out != 0)
    assert both.float().mean().item() > 0.4
    assert torch.equal(out[both], flax_out[both])
    # the old multiply is not the same function in any of these dtypes
    times = (x.float() * float(torch.tensor(1.0 / keep_prob, dtype=tdt))
             ).to(tdt).float()
    assert not torch.equal(times, expect)


@pytest.mark.parametrize("fmt", ["channels_last", "contiguous"])
def test_backward_mask_equals_forward_mask(fmt, rng):
    """The gradient is masked where the forward was, whatever memory
    format the incoming gradient has."""
    x = torch.from_numpy(rng.normal(size=(2, 3, 6, 5, 4)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    y = dropout(x, 42, 7, 0.4, "pallas")
    g = torch.ones(y.shape)
    if fmt == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last_3d)
    assert g.is_contiguous() == (fmt == "contiguous")
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx != 0, y != 0)
    assert torch.equal(dx[dx != 0], torch.full_like(dx[dx != 0], 1 / 0.6))


def test_mask_follows_logical_position_not_storage():
    x = torch.arange(1.0, 1.0 + 2 * 3 * 4 * 5 * 6).reshape(2, 3, 4, 5, 6)
    params = dropout_params(0.5, "pallas")
    a = dropout_plain(x, 3, 4, *params)
    b = dropout_plain(x.contiguous(memory_format=torch.channels_last_3d), 3,
                      4, *params)
    assert torch.equal(a, b)


def test_same_key_same_mask_other_stream_other_mask():
    x = torch.ones(4096)
    params = dropout_params(0.5, "pallas")
    a = dropout_apply(x, 10, 0, *params)
    assert torch.equal(a, dropout_apply(x, 10, 0, *params))
    assert not torch.equal(a, dropout_apply(x, 10, 1, *params))
    assert not torch.equal(a, dropout_apply(x, 11, 0, *params))


def test_network_layers_have_distinct_streams():
    net = build_network("VNet", num_classes=3, num_channels=4, num_levels=2,
                        num_convolutions=(1, 2), bottom_convolutions=1,
                        dropout_rate=0.5, device="cpu", dropout_impl="pallas")
    assert [m.index for m in net.dropouts] == list(range(7))
    net.train()
    with pytest.raises(ValueError, match="dropout_seed"):
        net(torch.zeros(1, 16, 16, 16, 1))
    x = torch.ones(1, 4, 8, 8, 8)
    masks = [m(x) != 0 for m in net.dropouts[:3] for _ in [net(
        torch.zeros(1, 16, 16, 16, 1), dropout_seed=5)]]
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


def test_cpu_takes_plain_and_counts_no_launch():
    before = dropout_apply.launches
    dropout_apply(torch.ones(100), 1, 2, 2 ** 31, 2.0, False)
    assert dropout_apply.launches == before


def test_wrapper_never_falls_back_off_the_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        dropout_apply(torch.empty(16, device="meta"), 1, 2, 2 ** 31, 2.0,
                      False)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="impl"):
        dropout_params(0.1, "cudnn")
    with pytest.raises(ValueError, match="rate"):
        dropout_params(0.0, "pallas")
    with pytest.raises(TypeError):
        dropout_apply(torch.ones(4, dtype=torch.float64), 1, 2, 2 ** 31, 2.0,
                      True)



@pytest.mark.parametrize("fmt", ["channels_last", "contiguous"])
def test_2d_activation_in_channels_last_counter_order(fmt, rng):
    """A 4-D ``(B, C, H, W)`` activation of the 2D network: the output is
    channels-last whatever the input's format, its mask is the counter
    stream in the JAX layout's ``(B, H, W, C)`` order, the keep fraction is
    within 5 sigma, survivors are ``x / keep_d`` rounded once, and the
    backward pass masks a gradient that is not channels-last where the
    forward pass masked."""
    rate = 0.3
    thr, keep, divide = dropout_params(rate, "xla")
    xn = (rng.normal(size=(4, 8, 64, 32)) * 40.0).astype(np.float32)
    x = torch.from_numpy(xn).to(torch.bfloat16)
    if fmt == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    y = dropout(x, 123, 4, rate, "xla")
    assert y.is_contiguous(memory_format=torch.channels_last)
    mask = keep_mask(y.numel(), 123, 4, thr).view(4, 64, 32, 8)
    assert torch.equal(y.detach().permute(0, 2, 3, 1) != 0, mask)
    n, p = y.numel(), thr / 2.0 ** 32
    assert abs(mask.sum().item() - n * p) < 5 * math.sqrt(n * p * (1 - p))
    keep_d = float(torch.tensor(keep, dtype=torch.bfloat16))
    expect = (x.detach().float() / keep_d).to(torch.bfloat16)
    assert torch.equal(y.detach()[y != 0], expect[y != 0])
    g = torch.ones(y.shape, dtype=y.dtype)  # row-major, not channels-last
    assert not g.is_contiguous(memory_format=torch.channels_last)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx != 0, y != 0)


# --- the kernel's division (csrc/dropout.cu, scale<true>) modelled exactly

_LO, _HI = -100, 127  # the kernel's guard: |x| >= 2^-100 (or 0), |q| < 2^127


def _rn32(m: int, e: int):
    """``m * 2**e`` rounded to the nearest float32 (ties to even, with
    subnormals) as ``(m', e')``, or ``None`` where it overflows."""
    if m == 0:
        return 0, 0
    a = abs(m)
    last = max(e + a.bit_length() - 24, -149)  # exponent of the last bit
    if last > e:
        s = last - e
        a, rest = a >> s, a & ((1 << s) - 1)
        if rest > 1 << (s - 1) or (rest == 1 << (s - 1) and a & 1):
            a += 1
        e = last
    if e + a.bit_length() - 1 > 127:
        return None
    return (a if m > 0 else -a), e


def _fma(a, b, c):
    """float32 ``fma(a, b, c)`` on exact dyadics ``(m, e)``: one rounding."""
    (ma, ea), (mb, eb), (mc, ec) = a, b, c
    e = min(ea + eb, ec)
    return _rn32((ma * mb << (ea + eb - e)) + (mc << (ec - e)), e)


def _dyadic(v: float):
    n, d = v.as_integer_ratio()
    return n, 1 - d.bit_length()


def _kernel_quotient(v: float, d, r):
    """The kernel's ``x / d`` for a finite float32 ``x``: ``q0 = RN(x *
    r)``, two corrections ``q' = fma(fma(-q, d, x), r, q)``, the sign of
    ``x``; ``(q, e1)`` with ``e1`` the second remainder, or ``None`` where
    the guard sends ``x`` to ``__fdiv_rn`` (``|x| < 2^-100`` and not 0, or
    ``|q| >= 2^127``)."""
    if v == 0.0:
        return v, (0, 0)  # q0 = q1 = q = +-0; copysign keeps x's zero
    x = _dyadic(v)
    if abs(v) < 2.0 ** _LO:
        return None
    q = _rn32(x[0] * r[0], x[1] + r[1])
    e = None
    for _ in range(2):
        if q is None:
            return None
        e = _fma((-q[0], q[1]), d, x)
        q = None if e is None else _fma(e, r, q)
    if q is None or abs(q[0]).bit_length() + q[1] - 1 >= _HI:
        return None
    return math.ldexp(q[0], q[1]), e


@pytest.mark.parametrize("name", ["bf16", "f16"])
def test_kernel_division_model_equals_ieee_division_exhaustively(name):
    """Every bf16 or f16 bit pattern x, at each rate of ``RATES``: the
    kernel's division without ``__fdiv_rn`` (the ``xla`` flavour, see
    ``csrc/dropout.cu``), modelled in exact integer arithmetic, equals
    ``dtype(f32(x) / f32(keep_d))`` (NaNs compared as NaN), and its last
    remainder ``fma(-q1, keep_d, x)`` is exact, as Markstein's theorem
    needs. The float32 quotients agree bit for bit before the rounding to
    the dtype, which alone would hide most one-ulp errors. Guarded
    patterns (non-finite, tiny, or a quotient near overflow) take the IEEE
    division in the kernel and here."""
    tdt = XLA_DTYPES[name][0]
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(tdt).float()
    values = x.tolist()
    for rate in RATES:
        _, keep, divide = dropout_params(rate, "xla")
        assert divide
        keep_d = float(torch.tensor(keep, dtype=tdt).float())
        recip = float(torch.tensor(1.0 / keep_d, dtype=torch.float32))
        quotient = x / torch.tensor(keep_d)  # float32, the IEEE division
        d, r = _dyadic(keep_d), _dyadic(recip)
        model, guarded = [], 0
        for v, q in zip(values, quotient.tolist()):
            got = _kernel_quotient(v, d, r) if math.isfinite(v) else None
            if got is None:
                guarded += 1
                model.append(q)  # __fdiv_rn, the IEEE division
                continue
            qv, e1 = got
            if qv != 0.0:
                residual = (fractions.Fraction(v)
                            - fractions.Fraction(qv) * fractions.Fraction(
                                keep_d))
                assert fractions.Fraction(math.ldexp(*e1)) == residual
            model.append(qv)
        got = torch.tensor(model, dtype=torch.float32)
        for a, b, view in ((got, quotient, torch.int32),
                           (got.to(tdt), quotient.to(tdt), torch.int16)):
            same = (a.view(view) == b.view(view)) | (a.isnan() & b.isnan())
            assert bool(same.all()), (rate, view, int((~same).sum()))
        assert guarded < 0.2 * len(values)  # NaNs, infinities, tiny, huge


def test_first_product_is_not_always_faithful():
    """Why the kernel corrects twice: ``RN(x * RN(1 / d))`` can lie more
    than one ulp from ``x / d``, outside the hypothesis of Markstein's
    theorem for a single correction; after one correction the quotient is
    faithful and the second is exact (float32, both operands in range)."""
    d = float.fromhex("0x1.e76424p-1")
    x = float.fromhex("0x1.0a2718p+0")
    r = float(torch.tensor(1.0) / torch.tensor(d))
    (mx, ex), (mr, er) = _dyadic(x), _dyadic(r)
    q0 = _rn32(mx * mr, ex + er)
    exact = fractions.Fraction(x) / fractions.Fraction(d)
    ulp = fractions.Fraction(2) ** (math.floor(math.log2(exact)) - 23)
    assert abs(fractions.Fraction(math.ldexp(*q0)) - exact) > ulp
    q, _ = _kernel_quotient(x, _dyadic(d), _dyadic(r))
    assert q == float(torch.tensor(x) / torch.tensor(d))


@pytest.mark.parametrize("base", [0, 1, 6, 135, 1 << 33])
def test_keep_mask_from_a_base_is_the_global_mask_slice(base):
    full = keep_mask(base % 64 + 300, 11, 4, 2 ** 31,
                     base=base - base % 64)
    part = keep_mask(300, 11, 4, 2 ** 31, base=base)
    np.testing.assert_array_equal(part.numpy(),
                                  full[base % 64:].numpy())


def test_dropout_plain_rank_rows_bitwise():
    """Rank r's plain dropout with base r * (its elements) is its rows of
    the global batch's, for each flavour; no two ranks share a mask."""
    x = torch.randn(4, 3, 5, 3, 3)  # 135 elements a row
    for impl in ("pallas", "bits8", "xla"):
        params = dropout_params(0.3, impl)
        whole = dropout_plain(x, 9, 2, *params)
        parts = [dropout_plain(x[r:r + 1], 9, 2, *params, base=135 * r)
                 for r in range(4)]
        assert torch.equal(torch.cat(parts), whole), impl
        assert not torch.equal(parts[0] != 0, parts[1] != 0)


def test_backward_with_a_base_regenerates_the_forward_mask():
    """The autograd Function keeps the base with the key: the gradient's
    mask is the forward's at an odd base."""
    x = torch.randn(2, 5, 3, 3, 3, requires_grad=True)
    y = dropout(x, 4, 1, 0.3, "pallas", base=135)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(dx != 0, y != 0)
    assert torch.equal(y, dropout_plain(x.detach(), 4, 1,
                                        *dropout_params(0.3, "pallas"),
                                        base=135))
