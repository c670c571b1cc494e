"""The port's dropout (``ops/dropout.py``) against the JAX package's.

The random streams differ by design (the port's is Philox4x32-10, JAX's
kernel uses the TPU's generator, flax threefry), so the tests hold the
port to the JAX formulas for threshold and scale, to the keep probability
within 5 standard deviations at 2^20 elements or more, to ``E[out] = x``,
and to the mask properties the training step relies on. The plain version
runs here; the CUDA kernel is held bitwise against it on the card (``cuda``
test below and ``chip_smoke.py`` phase 5).
"""

import math

import numpy as np
import pytest
import torch

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
    return {"pallas": (thr, 1.0 / keep), "xla": (thr, 1.0 / keep),
            "bits8": (t << 24, 256.0 / t)}


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
    thr, _ = dropout_params(rate, impl)
    p = thr / 2.0 ** 32
    kept = keep_mask(n, 1234, 5, thr).sum().item()
    assert abs(kept - n * p) < 5 * math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("impl", ["pallas", "bits8"])
def test_mean_is_preserved(impl):
    """``E[out] = x``: survivors are scaled by 1 / P(keep) exactly."""
    x = torch.full((1 << 20,), 3.0)
    thr, scale = dropout_params(0.3, impl)
    out = dropout_apply(x, 77, 1, thr, scale)
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
    thr, scale = dropout_params(0.2, "pallas")
    out = dropout_apply(x, 9, 2, thr, scale)
    out = out.permute(0, 2, 3, 4, 1).float()
    expect = torch.from_numpy(expect)
    kept = out != 0
    assert 0.7 < kept.float().mean().item() < 0.9
    assert torch.equal(out[kept], expect[kept])


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
    thr, scale = dropout_params(0.5, "pallas")
    a = dropout_plain(x, 3, 4, thr, scale)
    b = dropout_plain(x.contiguous(memory_format=torch.channels_last_3d), 3,
                      4, thr, scale)
    assert torch.equal(a, b)


def test_same_key_same_mask_other_stream_other_mask():
    x = torch.ones(4096)
    thr, scale = dropout_params(0.5, "pallas")
    a = dropout_apply(x, 10, 0, thr, scale)
    assert torch.equal(a, dropout_apply(x, 10, 0, thr, scale))
    assert not torch.equal(a, dropout_apply(x, 10, 1, thr, scale))
    assert not torch.equal(a, dropout_apply(x, 11, 0, thr, scale))


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
    dropout_apply(torch.ones(100), 1, 2, 2 ** 31, 2.0)
    assert dropout_apply.launches == before


def test_wrapper_never_falls_back_off_the_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        dropout_apply(torch.empty(16, device="meta"), 1, 2, 2 ** 31, 2.0)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="impl"):
        dropout_params(0.1, "cudnn")
    with pytest.raises(ValueError, match="rate"):
        dropout_params(0.0, "pallas")
    with pytest.raises(TypeError):
        dropout_apply(torch.ones(4, dtype=torch.float64), 1, 2, 2 ** 31, 2.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the dropout kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "bits8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_plain_on_card(impl, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((3, 16, 9, 8, 7), generator=gen, device=cuda_device
                    ).to(dtype)
    thr, scale = dropout_params(0.3, impl)
    before = dropout_apply.launches
    out_k = dropout_apply(x, 123, 4, thr, scale)
    out_p = dropout_plain(x, 123, 4, thr, scale)
    torch.cuda.synchronize()
    assert dropout_apply.launches == before + 1
    assert torch.equal(out_k, out_p)
