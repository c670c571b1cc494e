"""The port's custom-backward BatchNorm (``ops/batchnorm.py``) against the
JAX package's ``batch_norm_train`` with its default ``STATS_IMPL``, as
``tests/test_pallas_bn.py`` runs it.

Same seeded numpy inputs on both sides, float32, ``groups`` 1 and 8 (the
packed, offset-major layout). Values, mean and var, and the gradients of
``sum(y * w) + 0.3 sum(mean) + 0.7 sum(var)`` (which reach the direct
mean and var gradients) agree at ``rtol = 1e-4``, ``atol = 1e-5``. On the
CPU ``"pallas"`` runs the statistics wrappers' plain versions, so both
switches are compared here and on the card
(``tests/test_torch_cuda_batchnorm.py``, whose inputs this module shares,
and ``chip_smoke.py`` phase 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_batchnorm import C, _inputs
from vnet_tpu.ops.pallas import batchnorm as jax_bn
from vnet_tpu_torch.models.layers import BatchNorm
from vnet_tpu_torch.ops import batchnorm as bn
from vnet_tpu_torch.ops.fused import bn_grad_stats, bn_stats


def _jax_value_and_grads(x, scale, bias, w, groups):
    def loss(x, scale, bias):
        y, mean, var = jax_bn.batch_norm_train(x, scale, bias, 0.0, groups)
        return jnp.sum(y * w) + 0.3 * jnp.sum(mean) + 0.7 * jnp.sum(var)

    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return float(v), [np.asarray(a) for a in g]


def _torch_value_and_grads(x, scale, bias, w, groups):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y, mean, var = bn.batch_norm_train(*ts, 0.0, groups)
    loss = ((y * torch.from_numpy(w)).sum() + 0.3 * mean.sum()
            + 0.7 * var.sum())
    grads = torch.autograd.grad(loss, ts)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("groups", [1, 8])
def test_grads_match_jax(groups, impl, monkeypatch):
    monkeypatch.setattr(bn, "STATS_IMPL", impl)
    x, scale, bias, w = _inputs(groups)
    v_ref, g_ref = _jax_value_and_grads(x, scale, bias, w, groups)
    v, g = _torch_value_and_grads(x, scale, bias, w, groups)
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 8])
def test_forward_values_and_moments_match_jax(groups):
    x, scale, bias, _ = _inputs(groups, seed=1)
    y_ref, m_ref, v_ref = jax_bn.batch_norm_train(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 0.0, groups)
    y, mean, var = bn.batch_norm_train(torch.from_numpy(x),
                                       torch.from_numpy(scale),
                                       torch.from_numpy(bias), 0.0, groups)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(v_ref), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-5)
    xg = x.reshape(-1, groups, C)  # offset-major packing
    np.testing.assert_allclose(mean.numpy(), xg.mean((0, 1)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("groups", [1, 8])
def test_pallas_and_xla_switches_agree(groups, monkeypatch):
    x, scale, bias, w = _inputs(groups, seed=2)
    out = {}
    for impl in ("xla", "pallas"):
        monkeypatch.setattr(bn, "STATS_IMPL", impl)
        before = (bn_stats.launches, bn_grad_stats.launches)
        out[impl] = _torch_value_and_grads(x, scale, bias, w, groups)
        assert (bn_stats.launches, bn_grad_stats.launches) == before
    np.testing.assert_allclose(out["pallas"][0], out["xla"][0], rtol=1e-6)
    for a, b in zip(out["pallas"][1], out["xla"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_only_mean_used_takes_no_y_gradient():
    """A missing incoming gradient counts as zero (here dy and dvar)."""
    x, scale, bias, _ = _inputs(1, seed=3)

    def loss(x, scale, bias):
        return jnp.sum(jax_bn.batch_norm_train(x, scale, bias, 0.0, 1)[1])

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    _, mean, _ = bn.batch_norm_train(*ts)
    grads = torch.autograd.grad(mean.sum(), ts, allow_unused=True)
    for a, b in zip(grads, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_bf16_dtype_preserved():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_()
    scale = torch.ones(16, requires_grad=True)
    y, mean, var = bn.batch_norm_train(x, scale, torch.zeros(16), 0.0, 1)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    dx, ds = torch.autograd.grad(y.float().sum(), (x, scale))
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32


def test_variance_is_not_clamped():
    """Unlike ``models.layers.BatchNorm``: a constant channel's variance is
    E[x^2] - E[x]^2 as computed, which float32 may leave below zero."""
    x = torch.full((3, 5, 2), 0.1)
    _, _, var = bn.batch_norm_train(x, torch.ones(2), torch.zeros(2))
    xf = x.reshape(-1, 2)
    expect = (xf * xf).sum(0) / 15 - (xf.sum(0) / 15).square()
    torch.testing.assert_close(var, expect, rtol=0, atol=0)


def test_matches_layers_batchnorm_at_groups_1():
    x, scale, bias, w = _inputs(1, seed=4)
    layer = BatchNorm(C).train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y_ref = layer(xt.permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
    g_ref = torch.autograd.grad((y_ref * torch.from_numpy(w)).sum(),
                                (xt, layer.weight, layer.bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y, _, _ = bn.batch_norm_train(*ts)
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_stats_impl_switch(impl, monkeypatch):
    monkeypatch.setattr(bn, "STATS_IMPL", impl)
    assert bn.stats_impl(torch.zeros(1)) == ("xla" if impl == "auto"
                                             else impl)


def test_bad_switch_and_groups_raise(monkeypatch):
    with pytest.raises(ValueError, match="channels"):
        bn.batch_norm_train(torch.zeros(2, 12), torch.ones(4), torch.zeros(4),
                            0.0, 2)
    monkeypatch.setattr(bn, "STATS_IMPL", "mosaic")
    with pytest.raises(ValueError, match="STATS_IMPL"):
        bn.batch_norm_train(torch.zeros(2, 4), torch.ones(4), torch.zeros(4))
