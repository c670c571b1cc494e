"""Weight conversion between flax variables and the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu_torch.convert import (flax_to_state_dict, kernel_to_flax,
                                    kernel_to_torch, state_dict_to_flax)
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
                         **SMALL)
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
