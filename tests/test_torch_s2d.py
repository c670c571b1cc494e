"""``vnet_tpu_torch/ops/s2d.py`` and ``ops/conv_vjp.py`` against the JAX
package's ``vnet_tpu/ops/s2d.py`` and ``vnet_tpu/ops/conv_vjp.py``.

The same numpy inputs and kernels (converted with ``convert.py``'s layout
functions) go through both. Layout moves and gathers are held bitwise:
``space_to_depth``/``depth_to_space`` for every per-axis factor combination
at rank 2 and 3, ``pack_kernel`` with and without ``input_splits``, and
``adaptive_factors`` over a grid of extents and widths. The convolutions
and matrix products sum in another order on each side, so outputs and the
gradients with respect to x and the *original* kernel are held in float32
at ``atol = rtol = 1e-4``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.models.vnet import adaptive_factors as jax_adaptive_factors
from vnet_tpu.ops import conv_vjp as jcv
from vnet_tpu.ops import s2d as js
from vnet_tpu_torch.convert import kernel_to_flax, kernel_to_torch
from vnet_tpu_torch.models.vnet import adaptive_factors
from vnet_tpu_torch.ops import conv_vjp as tcv
from vnet_tpu_torch.ops import s2d as ts

from torch_parity import from_port, to_port

TOL = dict(atol=1e-4, rtol=1e-4)
FACTORS = ([f for f in itertools.product((1, 2), repeat=2)]
           + [f for f in itertools.product((1, 2), repeat=3)])


def _x(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _port(x):
    """numpy ``(B, *s, C)`` -> a port tensor that requires grad."""
    return to_port(x).clone().requires_grad_()


def _kernel(rng, k, rank, cin, cout):
    lim = np.sqrt(6.0 / (k ** rank * (cin + cout)))
    return rng.uniform(-lim, lim, (k,) * rank + (cin, cout)).astype(
        np.float32)


def _vjp(fn, cot, *args):
    """JAX output and the gradients of ``sum(out * cot)``."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("factors", FACTORS, ids=str)
def test_space_to_depth_round_trip_bitwise(factors, rng):
    rank = len(factors)
    x = _x(rng, (2,) + (4, 6, 2)[:rank] + (3,))
    ref = np.asarray(js.space_to_depth(jnp.asarray(x), factors=factors))
    xp = ts.space_to_depth(to_port(x), factors=factors)
    np.testing.assert_array_equal(from_port(xp), ref)
    back = ts.depth_to_space(xp, factors=factors)
    np.testing.assert_array_equal(
        from_port(back),
        np.asarray(js.depth_to_space(jnp.asarray(ref), factors=factors)))
    np.testing.assert_array_equal(from_port(back), x)
    if any(f == 2 for f in factors):  # one copy, channels-last out
        fmt = torch.channels_last_3d if rank == 3 else torch.channels_last
        assert xp.is_contiguous(memory_format=fmt)


@pytest.mark.parametrize("rank,k,factors,splits", [
    (3, 5, None, None), (3, 5, (2, 2, 1), None), (3, 5, (2, 1, 1), None),
    (3, 3, (1, 2, 2), None), (3, 1, None, None), (2, 5, (2, 1), None),
    (3, 5, None, (3, 3)), (3, 5, (2, 1, 2), (2, 4)), (2, 3, None, (3, 3))])
def test_pack_kernel_bitwise(rank, k, factors, splits, rng):
    kernel = _kernel(rng, k, rank, 6, 4)
    ref = np.asarray(js.pack_kernel(jnp.asarray(kernel), input_splits=splits,
                                    factors=factors))
    w = torch.from_numpy(kernel_to_torch(kernel, False).copy())
    got = ts.pack_kernel(w, input_splits=splits, factors=factors)
    np.testing.assert_array_equal(kernel_to_flax(got.numpy(), False), ref)
    assert ts.packed_pads(k, ts.norm_factors(factors, rank)) == \
        js.packed_pads(k, js._norm_factors(factors, rank))


def test_adaptive_factors_equal_jax():
    for spatial in itertools.product((1, 3, 4, 8, 16), repeat=3):
        for ch in (4, 16, 32, 64, 128, 256):
            for lanes in (16, 64, 128, 512):
                assert adaptive_factors(spatial, ch, lanes) == \
                    jax_adaptive_factors(spatial, ch, lanes), (spatial, ch)
    for spatial in itertools.product((2, 5, 64), repeat=2):
        for ch in (16, 64):
            assert adaptive_factors(spatial, ch, 128) == \
                jax_adaptive_factors(spatial, ch, 128)


@pytest.mark.parametrize("factors,splits,dw_impl", [
    ((2, 2, 2), None, "xla"), ((2, 2, 1), None, "xla"),
    ((2, 1, 1), None, "custom"), ((1, 2, 1), None, "pallas"),
    ((2, 2, 2), (3, 3), "pallas"), ((2, 1), None, "xla"),
    ((2, 2), (3, 3), "custom")], ids=str)
def test_packed_conv_and_gradients(factors, splits, dw_impl, rng):
    rank = len(factors)
    g = int(np.prod(factors))
    xp = _x(rng, (2,) + (4, 2, 4)[:rank] + (g * 6,))
    kernel = _kernel(rng, 5, rank, 6, 4)
    cot = _x(rng, xp.shape[:-1] + (g * 4,))
    ref, (dx_ref, dk_ref) = _vjp(
        lambda a, b: js.packed_conv(a, b, input_splits=splits,
                                    factors=factors), cot, xp, kernel)
    x_t = _port(xp)
    w = torch.from_numpy(kernel_to_torch(kernel, False).copy())
    w.requires_grad_()
    y = ts.packed_conv(x_t, w, input_splits=splits, factors=factors,
                       dw_impl=dw_impl)
    y.backward(to_port(cot))
    np.testing.assert_allclose(from_port(y), ref, **TOL)
    np.testing.assert_allclose(from_port(x_t.grad), dx_ref, **TOL)
    np.testing.assert_allclose(kernel_to_flax(w.grad.numpy(), False), dk_ref,
                               **TOL)


@pytest.mark.parametrize("factors,keep", [
    ((2, 2, 2), False), ((2, 2, 2), True), ((2, 2, 1), False),
    ((2, 1, 1), False), ((1, 2, 1), False), ((2, 2), True),
    ((1, 2), False)], ids=str)
def test_packed_down_conv_and_gradients(factors, keep, rng):
    rank = len(factors)
    g = int(np.prod(factors))
    grid = tuple(8 // f for f in factors)
    xp = _x(rng, (2,) + grid + (g * 3,))
    kernel = _kernel(rng, 2, rank, 3, 5)
    out_grid = tuple(4 // (2 if keep else 1) for _ in factors)
    cot = _x(rng, (2,) + out_grid + ((2 ** rank if keep else 1) * 5,))
    ref, (dx_ref, dk_ref) = _vjp(
        lambda a, b: js.packed_down_conv(a, b, keep_packed=keep,
                                         factors=factors), cot, xp, kernel)
    x_t = _port(xp)
    w = torch.from_numpy(kernel_to_torch(kernel, False).copy())
    w.requires_grad_()
    y = ts.packed_down_conv(x_t, w, keep_packed=keep, factors=factors)
    y.backward(to_port(cot))
    np.testing.assert_allclose(from_port(y), ref, **TOL)
    np.testing.assert_allclose(from_port(x_t.grad), dx_ref, **TOL)
    np.testing.assert_allclose(kernel_to_flax(w.grad.numpy(), False), dk_ref,
                               **TOL)


@pytest.mark.parametrize("keep,out_factors", [
    (False, None), (True, None), (True, (2, 2, 2)), (True, (2, 2, 1)),
    (True, (2, 1, 1)), (True, (1, 1, 2)), (True, (2, 1)), (False, "2d")],
    ids=str)
def test_s2d_up_conv_and_gradients(keep, out_factors, rng):
    rank = 2 if out_factors in ("2d", (2, 1)) else 3
    out_factors = None if out_factors == "2d" else out_factors
    x = _x(rng, (2,) + (4, 2, 6)[:rank] + (6,))
    kernel = _kernel(rng, 2, rank, 6, 3)
    y_ref = js.s2d_up_conv(jnp.asarray(x), jnp.asarray(kernel),
                           keep_packed=keep, out_factors=out_factors)
    cot = _x(rng, y_ref.shape)
    ref, (dx_ref, dk_ref) = _vjp(
        lambda a, b: js.s2d_up_conv(a, b, keep_packed=keep,
                                    out_factors=out_factors), cot, x, kernel)
    x_t = _port(x)
    # the port's transpose weight is the JAX kernel spatially flipped
    w = torch.from_numpy(kernel_to_torch(kernel, True).copy())
    w.requires_grad_()
    y = ts.s2d_up_conv(x_t, w, keep_packed=keep, out_factors=out_factors)
    y.backward(to_port(cot))
    np.testing.assert_allclose(from_port(y), ref, **TOL)
    np.testing.assert_allclose(from_port(x_t.grad), dx_ref, **TOL)
    np.testing.assert_allclose(kernel_to_flax(w.grad.numpy(), True), dk_ref,
                               **TOL)


@pytest.mark.parametrize("rank,k", [(3, 5), (3, 3), (2, 5)])
def test_s2d_conv_and_down_conv_equal_direct(rank, k, rng):
    x = _x(rng, (2,) + (8, 4, 6)[:rank] + (3,))
    kernel = _kernel(rng, k, rank, 3, 4)
    cot = _x(rng, x.shape[:-1] + (4,))
    ref, (dx_ref, dk_ref) = _vjp(js.s2d_conv, cot, x, kernel)
    x_t = _port(x)
    w = torch.from_numpy(kernel_to_torch(kernel, False).copy())
    w.requires_grad_()
    y = ts.s2d_conv(x_t, w)
    y.backward(to_port(cot))
    np.testing.assert_allclose(from_port(y), ref, **TOL)
    np.testing.assert_allclose(from_port(x_t.grad), dx_ref, **TOL)
    np.testing.assert_allclose(kernel_to_flax(w.grad.numpy(), False), dk_ref,
                               **TOL)
    kd = _kernel(rng, 2, rank, 3, 4)
    down = ts.s2d_down_conv(to_port(x), torch.from_numpy(
        kernel_to_torch(kd, False).copy()))
    np.testing.assert_allclose(
        from_port(down),
        np.asarray(js.s2d_down_conv(jnp.asarray(x), jnp.asarray(kd))), **TOL)


@pytest.mark.parametrize("rank,k,pads", [
    (3, (3, 3, 5), None), (3, (5, 5, 5), ((2, 2), (1, 3), (0, 4))),
    (2, (3, 5), None), (2, (4, 2), ((1, 2), (0, 1)))], ids=str)
def test_conv_custom_dw_equals_jax(rank, k, pads, rng):
    pads = pads or jcv.same_pads(k)
    assert tcv.same_pads(k) == jcv.same_pads(k)
    x = _x(rng, (2,) + (6, 5, 4)[:rank] + (3,))
    lim = 0.3
    kernel = rng.uniform(-lim, lim, k + (3, 4)).astype(np.float32)
    ref_y = jcv.conv_custom_dw(jnp.asarray(x), jnp.asarray(kernel), pads)
    cot = _x(rng, ref_y.shape)
    ref, (dx_ref, dk_ref) = _vjp(
        lambda a, b: jcv.conv_custom_dw(a, b, pads), cot, x, kernel)
    x_t = _port(x)
    w = torch.from_numpy(kernel_to_torch(kernel, False).copy())
    w.requires_grad_()
    y = tcv.conv_custom_dw(x_t, w, pads)
    y.backward(to_port(cot))
    np.testing.assert_allclose(from_port(y), ref, **TOL)
    np.testing.assert_allclose(from_port(x_t.grad), dx_ref, **TOL)
    np.testing.assert_allclose(kernel_to_flax(w.grad.numpy(), False), dk_ref,
                               **TOL)


def test_pack_kernel_on_the_meta_device():
    """The dropout benchmark enumerates shapes on the ``meta`` device: the
    packed path builds its gather there too."""
    w = torch.empty(4, 6, 5, 5, 5, device="meta")
    assert ts.pack_kernel(w, factors=(2, 2, 1)).shape == (16, 24, 3, 3, 5)
    xp = torch.empty(2, 24, 4, 4, 8, device="meta")
    assert ts.packed_conv(xp, w, factors=(2, 2, 1)).shape == (2, 16, 4, 4, 8)


def test_packed_conv_trains_after_a_first_call_in_inference_mode(rng):
    """The packing map is made once per device: made under
    ``torch.inference_mode`` (an evaluation first), it still serves a
    training step's autograd."""
    ts._pack_gather.cache_clear()
    xp = torch.from_numpy(_x(rng, (1, 8 * 2, 4, 4, 4)))
    w = torch.from_numpy(_x(rng, (2, 2, 3, 3, 3))).requires_grad_()
    with torch.inference_mode():
        ts.packed_conv(xp, w.detach())
    ts.packed_conv(xp, w).sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
