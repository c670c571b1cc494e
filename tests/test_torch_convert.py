"""Conversion between flax and the port: variables, gradients and Adam
state."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu_torch.convert import (adam_state_from_optax,
                                    adam_state_to_optax, flax_to_grads,
                                    flax_to_state_dict, grads_to_flax,
                                    kernel_to_flax, kernel_to_torch,
                                    state_dict_to_flax)
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.models.layers import SpatialConvTranspose

from torch_parity import random_variables

SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("in_channels", [1, 2])
def test_round_trip_names_shapes_values(in_channels, rng):
    net = jax_build_network("VNet", norm="batch", **SMALL)
    x = jnp.zeros((1, 16, 16, 16, in_channels))
    variables = random_variables(net, rng, x, train=False)

    sd = flax_to_state_dict(variables)
    port = build_network("VNet", in_channels=in_channels, norm="batch",
                         device="cpu", **SMALL)
    expected = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == expected
    port.load_state_dict(sd, strict=True)

    back = dict(_flat(state_dict_to_flax(sd)))
    orig = dict(_flat(variables))
    assert back.keys() == orig.keys()
    for key, value in orig.items():
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


@pytest.mark.parametrize("transpose", [False, True])
def test_kernel_layout_inverse(transpose, rng):
    k = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        kernel_to_flax(kernel_to_torch(k, transpose), transpose), k)


@pytest.mark.parametrize("cin,cout", [(1, 3), (4, 2)])
def test_transpose_conv_matches_lax_conv_transpose(cin, cout, rng):
    """``lax.conv_transpose`` does not flip its kernel; the port's
    ``F.conv_transpose3d`` weight is the flipped kernel with in/out swapped
    into ``(I, O, ...)``. With one input channel every output is a single
    product, so the two agree bit for bit."""
    x = rng.normal(size=(2, 3, 4, 5, cin)).astype(np.float32)
    k = rng.normal(size=(2, 2, 2, cin, cout)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(k), (2, 2, 2), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))
    mod = SpatialConvTranspose(cin, cout, (2, 2, 2), (2, 2, 2))
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            kernel_to_torch(k, transpose=True))))
        mod.bias.zero_()
        out = mod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    out = out.permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape == (2, 6, 8, 10, cout)
    if cin == 1:
        np.testing.assert_array_equal(out, ref)
    else:  # channel sums in another order
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _params_and_grads(rng):
    net = jax_build_network("VNet", norm="batch", **SMALL)
    variables = random_variables(net, rng, jnp.zeros((1, 16, 16, 16, 1)),
                                 train=False)
    params = variables["params"]
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(3)]
    return params, grads


def test_gradients_map_like_params(rng):
    params, grads = _params_and_grads(rng)
    port = build_network("VNet", norm="batch", device="cpu", **SMALL)
    mapped = flax_to_grads(grads[0])
    assert {k: tuple(v.shape) for k, v in mapped.items()} == {
        k: tuple(p.shape) for k, p in port.named_parameters()}
    back = dict(_flat(grads_to_flax(mapped)))
    for key, value in _flat(grads[0]):
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_adam_state_carries_across(rng):
    """An optax Adam state loaded into ``torch.optim.Adam`` round-trips
    exactly, and the next step from it agrees with optax's (same update
    formula; torch takes the bias corrections in float64, optax in float32,
    so parameters of order 1 agree to ``rtol = 1e-5``, ``atol = 1e-6``)."""
    params, grads = _params_and_grads(rng)
    tx = optax.adam(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads[:2]:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    port = build_network("VNet", norm="batch", device="cpu", **SMALL)
    port.load_state_dict(flax_to_state_dict(
        {"params": jax.device_get(jp),
         "batch_stats": random_variables(
             jax_build_network("VNet", norm="batch", **SMALL), rng,
             jnp.zeros((1, 16, 16, 16, 1)), train=False)["batch_stats"]}))
    opt = torch.optim.Adam(port.parameters(), lr=1e-2)
    adam_state_from_optax(opt, port, opt_state)

    back = adam_state_to_optax(opt, port)
    assert back["count"] == 2
    for name in ("mu", "nu"):
        ref = dict(_flat(jax.device_get(getattr(opt_state[0], name))))
        for key, value in _flat(back[name]):
            np.testing.assert_array_equal(value, ref[key], err_msg=str(key))

    updates, _ = tx.update(grads[2], opt_state, jp)
    jp = optax.apply_updates(jp, updates)
    for n, p in port.named_parameters():
        p.grad = flax_to_grads(grads[2])[n]
    opt.step()
    got = dict(_flat(state_dict_to_flax(
        dict(port.named_parameters()))["params"]))
    for key, value in _flat(jax.device_get(jp)):
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6,
                                   err_msg=str(key))
