"""Port layers and the whole VNet against the JAX modules, eval mode.

Same numpy inputs and the same (converted) variables go through the flax
module and its port. Both VNets run as their evaluators build them
(``conv_impl="packed"``: the exact space-to-depth rewrite, adaptive
packing at 128 lanes); the single layers run direct on the port's side.
Sums are taken in another order in the two frameworks: float32 cases
compare at ``atol = rtol = 1e-4``; the bfloat16 case, which rounds at
other places in the two frameworks (8-bit mantissa, errors compound over
the network's depth), at ``atol = 0.25, rtol = 0.1`` per element and a
mean absolute error below 0.02. ``tests/test_torch_packed_vnet.py`` holds
the packed network in training mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.models import eval_apply as jax_eval_apply
from vnet_tpu.models import layers as jl
from vnet_tpu_torch.convert import flax_to_state_dict
from vnet_tpu_torch.models import build_network, eval_apply
from vnet_tpu_torch.models import layers as tl

from torch_parity import from_port, jax_apply, random_variables, to_port

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.25, rtol=0.1)
BF16_MEAN_ATOL = 0.02


def _port_out(module, variables, x):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    module.eval()
    with torch.no_grad():
        return from_port(module(to_port(x)))


@pytest.mark.parametrize("kind", ["batch", "batch_stats", "group",
                                  "instance", "none"])
def test_norm(kind, rng):
    x = rng.normal(1.0, 2.0, size=(2, 6, 5, 4, 8)).astype(np.float32)
    mod = jl.Norm(kind)
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.Norm(kind, 8), v, x)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("kind", ["batch", "batch_stats"])
def test_tiled_input_batch_norm(kind, rng):
    x = rng.normal(3.0, 2.0, size=(2, 6, 5, 4, 1)).astype(np.float32)
    mod = jl.TiledInputBatchNorm(16, kind)
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.TiledInputBatchNorm(16, kind), v, x)
    assert out.shape == (2, 6, 5, 4, 16)
    np.testing.assert_allclose(out, ref, **TOL)


def test_prelu(rng):
    x = rng.normal(size=(2, 4, 4, 4, 5)).astype(np.float32)
    mod = jl.PReLU()
    v = random_variables(mod, rng, jnp.asarray(x))
    ref = jax_apply(mod, v, jnp.asarray(x))
    out = _port_out(tl.PReLU(5), v, x)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("impl", ["direct", "auto"])
def test_spatial_conv(impl, rng):
    x = rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32)
    mod = jl.conv(5, 5, 3, impl=impl)
    v = random_variables(mod, rng, jnp.asarray(x))
    ref = jax_apply(mod, v, jnp.asarray(x))
    out = _port_out(tl.SpatialConv(3, 5, (5, 5, 5)), v, x)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm", ["batch", "batch_stats"])
def test_down_conv(norm, rng):
    x = rng.normal(size=(2, 8, 6, 4, 4)).astype(np.float32)
    mod = jl.DownConv(2, norm, "prelu", impl="auto")
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.DownConv(4, 2, norm, "prelu"), v, x)
    assert out.shape == (2, 4, 3, 2, 8)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm", ["batch", "batch_stats"])
def test_up_conv(norm, rng):
    x = rng.normal(size=(2, 4, 3, 2, 8)).astype(np.float32)
    mod = jl.UpConv(2, norm, "prelu", impl="auto")
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.UpConv(8, 2, norm, "prelu"), v, x)
    assert out.shape == (2, 8, 6, 4, 4)
    np.testing.assert_allclose(out, ref, **TOL)


SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1,
             dropout_rate=0.0)


def _vnet_pair(norm, in_channels, rng, dtype_jax=None,
               dtype_port=torch.float32, batch=2):
    x = rng.normal(50.0, 20.0, size=(batch, 16, 16, 16, in_channels)
                   ).astype(np.float32)
    net = jax_build_network("VNet", norm=norm, dtype=dtype_jax, **SMALL)
    v = random_variables(net, rng, jnp.asarray(x), train=False)
    ref = np.asarray(jax_eval_apply(net, v, jnp.asarray(x)))
    port = build_network("VNet", in_channels=in_channels, norm=norm,
                         dtype=dtype_port, device="cpu", **SMALL)
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    out = eval_apply(port, torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    return out, ref


@pytest.mark.parametrize("norm,in_channels", [
    ("batch", 1), ("batch_stats", 1), ("batch", 2), ("group", 1)])
def test_vnet_eval_f32(norm, in_channels, rng):
    out, ref = _vnet_pair(norm, in_channels, rng)
    np.testing.assert_allclose(out, ref, **TOL)


def test_vnet_eval_bf16(rng):
    out, ref = _vnet_pair("batch_stats", 1, rng, dtype_jax=jnp.bfloat16,
                          dtype_port=torch.bfloat16)
    err = np.abs(out - ref)
    assert err.mean() < BF16_MEAN_ATOL, err.mean()
    np.testing.assert_allclose(out, ref, **BF16_TOL)


def test_vnet_batch_stats_depends_on_batch(rng):
    """``batch_stats`` normalises with the evaluation batch itself, so
    adding a patch to the batch changes the others' logits — the reason the
    sliding window pads grids exactly as JAX does."""
    x = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    port = build_network("VNet", norm="batch_stats", device="cpu", **SMALL)
    both = eval_apply(port, torch.from_numpy(x))
    first = eval_apply(port, torch.from_numpy(x[:1]))
    assert not torch.allclose(both[:1], first)


def _jax_train(mod, v, x):
    out, mutated = jax.jit(lambda vv, xx: mod.apply(
        vv, xx, train=True, mutable=["batch_stats"]))(v, x)
    return np.asarray(out), jax.device_get(mutated["batch_stats"])


@pytest.mark.parametrize("kind,tiled", [("batch", False),
                                        ("batch_stats", False),
                                        ("batch", True)])
def test_batch_norm_train_updates_running_averages(kind, tiled, rng):
    """Train mode: batch statistics, and the running averages move by
    flax's ``0.99 * running + 0.01 * batch`` with the biased variance."""
    c_in = 1 if tiled else 8
    x = rng.normal(1.0, 2.0, size=(2, 6, 5, 4, c_in)).astype(np.float32)
    mod = jl.TiledInputBatchNorm(8, kind) if tiled else jl.Norm(kind)
    v = random_variables(mod, rng, jnp.asarray(x), train=True)
    ref, stats = _jax_train(mod, v, jnp.asarray(x))
    port = tl.TiledInputBatchNorm(8, kind) if tiled else tl.Norm(kind, 8)
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    port.train()
    with torch.no_grad():
        out = from_port(port(to_port(x)))
    np.testing.assert_allclose(out, ref, **TOL)
    sd = port.state_dict()
    np.testing.assert_allclose(sd["bn.running_mean"].numpy(),
                               stats["bn"]["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sd["bn.running_var"].numpy(),
                               stats["bn"]["var"], rtol=1e-6, atol=1e-7)


def test_eval_mode_leaves_running_averages(rng):
    port = tl.Norm("batch_stats", 8)
    port.eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        port(to_port(rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("impl", ["direct", "auto"])
def test_spatial_conv_2d(impl, rng):
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    mod = jl.conv(5, 5, 2, impl=impl)
    v = random_variables(mod, rng, jnp.asarray(x))
    ref = jax_apply(mod, v, jnp.asarray(x))
    conv = tl.SpatialConv(3, 5, (5, 5))
    assert conv.strides == (1, 1)
    out = _port_out(conv, v, x)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm", ["batch", "batch_stats"])
def test_down_conv_2d(norm, rng):
    x = rng.normal(size=(2, 8, 6, 4)).astype(np.float32)
    mod = jl.DownConv(2, norm, "prelu", impl="auto")
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.DownConv(4, 2, norm, "prelu", rank=2), v, x)
    assert out.shape == (2, 4, 3, 8)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm", ["batch", "batch_stats"])
def test_up_conv_2d(norm, rng):
    x = rng.normal(size=(2, 4, 3, 8)).astype(np.float32)
    mod = jl.UpConv(2, norm, "prelu", impl="auto")
    v = random_variables(mod, rng, jnp.asarray(x), train=False)
    ref = jax_apply(mod, v, jnp.asarray(x), train=False)
    out = _port_out(tl.UpConv(8, 2, norm, "prelu", rank=2), v, x)
    assert out.shape == (2, 8, 6, 4)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("norm,in_channels", [
    ("batch", 1), ("batch_stats", 1), ("batch", 2), ("batch_stats", 2)])
def test_vnet_2d_eval_f32(norm, in_channels, rng):
    """The 2D network (``spatial_rank=2``) against JAX's VNet on rank-2
    input, eval mode, float32."""
    x = rng.normal(50.0, 20.0, size=(3, 32, 32, in_channels)).astype(
        np.float32)
    net = jax_build_network("VNet", norm=norm, **SMALL)
    v = random_variables(net, rng, jnp.asarray(x), train=False)
    ref = np.asarray(jax_eval_apply(net, v, jnp.asarray(x)))
    port = build_network("VNet", in_channels=in_channels, norm=norm,
                         device="cpu", spatial_rank=2, **SMALL)
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    out = eval_apply(port, torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == (
        3, 32, 32, 3)
    np.testing.assert_allclose(out, ref, **TOL)


def test_vnet_2d_keeps_channels_last():
    """Training mode at rank 2: every convolution's and every dropout's
    input is channels-last (``torch.channels_last``), through the tiled
    input norm, the decoder's concat and dropout itself, so no layer pays a
    layout copy; a 2D ``AttentionVNet`` is refused."""
    port = build_network("VNet", device="cpu", spatial_rank=2,
                         **dict(SMALL, dropout_rate=0.1))
    seen = []
    for m in port.modules():
        if isinstance(m, (tl.SpatialConv, tl.Dropout)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(
                (type(mod).__name__, args[0].is_contiguous(
                    memory_format=torch.channels_last))))
    port.train()
    port(torch.ones(2, 16, 16, 1), dropout_seed=3).sum().backward()
    assert len(seen) == 7 + 10  # 7 dropouts; 7 block, 2 down, 1 output conv
    assert all(cl for _, cl in seen), seen
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_network("AttentionVNet", num_classes=2, device="cpu",
                      spatial_rank=2)
