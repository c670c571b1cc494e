"""The port's sliding window against the JAX one.

Both run the same per-voxel model whose logits depend on the mean of the
whole batch, like ``Norm: batch_stats``: if the port padded the patch grid
to whole batches differently from JAX (the last real row repeated with
flag 0), its outputs would differ. Float32 softmax and einsum on two
frameworks differ in the last bits, so outputs compare at
``atol = rtol = 1e-5``; the port's two blend routes add the same numbers
in the same order and must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.infer import sliding_window as jsw
from vnet_tpu_torch.infer import sliding_window as tsw

VOLUME = (20, 18, 13, 2)
PATCH, STRIDE, BATCH, CLASSES = (8, 8, 6), (5, 6, 4), 5, 3
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim,patch,stride", [
    (20, 8, 5), (13, 6, 4), (16, 16, 8), (33, 16, 16), (5, 5, 2)])
def test_patch_starts_match(dim, patch, stride):
    assert tsw.patch_starts_1d(dim, patch, stride) == \
        jsw.patch_starts_1d(dim, patch, stride)


def test_grid_and_window_match():
    np.testing.assert_array_equal(
        tsw.build_patch_grid(VOLUME[:3], PATCH, STRIDE),
        jsw.build_patch_grid(VOLUME[:3], PATCH, STRIDE))
    np.testing.assert_array_equal(tsw.cosine_window(PATCH),
                                  jsw.cosine_window(PATCH))


def _model(rng):
    w = rng.normal(size=(VOLUME[-1], CLASSES)).astype(np.float32)
    b = rng.normal(size=(CLASSES,)).astype(np.float32)

    def jax_fn(v, p):
        return jnp.einsum("...c,ck->...k", p - p.mean(), v["w"]) + v["b"]

    def port_fn(p):
        return torch.einsum("...c,ck->...k", p - p.mean(),
                            torch.from_numpy(w)) + torch.from_numpy(b)

    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jax_fn, port_fn


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("gaussian", [False, True])
def test_sliding_window_matches_jax(gaussian, hard, jax_impl, rng):
    n = len(jsw.build_patch_grid(VOLUME[:3], PATCH, STRIDE))
    assert n % BATCH, "the grid must need flag-0 padding rows"
    volume = rng.normal(size=VOLUME).astype(np.float32)
    variables, jax_fn, port_fn = _model(rng)
    kw = dict(gaussian_blend=gaussian, hard_accumulate=hard)
    ref_acc, ref_w = jsw.SlidingWindowInference(
        jax_fn, PATCH, STRIDE, BATCH, CLASSES, blend_impl=jax_impl,
        **kw)(variables, volume)
    outs = {}
    for impl in ("pallas", "xla"):
        acc, w = tsw.SlidingWindowInference(
            port_fn, PATCH, STRIDE, BATCH, CLASSES, blend_impl=impl,
            device="cpu", **kw)(volume)
        outs[impl] = (acc.numpy(), w.numpy())
        np.testing.assert_allclose(outs[impl][0], np.asarray(ref_acc), **TOL)
        np.testing.assert_allclose(outs[impl][1], np.asarray(ref_w), **TOL)
    for a, b in zip(outs["pallas"], outs["xla"]):
        np.testing.assert_array_equal(a, b)


def test_volume_smaller_than_patch_raises():
    engine = tsw.SlidingWindowInference(lambda p: p, PATCH, STRIDE, BATCH,
                                        CLASSES, device="cpu")
    with pytest.raises(ValueError, match="smaller than patch"):
        engine(np.zeros((7, 8, 6, 1), np.float32))


def test_default_device_is_cuda_and_raises_without_a_card():
    """Like every entry point of the port, the engine runs on the card
    unless the caller asks for the CPU: no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card, so the default resolves")
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        tsw.SlidingWindowInference(lambda p: p, PATCH, STRIDE, BATCH,
                                   CLASSES)


STACK = (13, 20, 18, 2)  # (Z, H, W, C); Z is not a multiple of JAX's 8
PATCH_2D, STRIDE_2D = (8, 8), (5, 6)


@pytest.mark.parametrize("gaussian", [False, True])
def test_slice_stacked_matches_jax(gaussian, rng):
    """The stacked 2D engine against JAX's slice-stacked XLA engine, which
    pads the stack to 16 slices (its z bucket) and the grid to match; the
    port pads neither, and with a model that depends on the batch mean the
    outputs still agree, so the batches hold the same patches. Both of the
    port's blend routes agree exactly."""
    n = STACK[0] * len(jsw.build_patch_grid(STACK[1:3], PATCH_2D, STRIDE_2D))
    assert n % BATCH, "the grid must need flag-0 padding rows"
    volume = rng.normal(size=STACK).astype(np.float32)
    variables, jax_fn, port_fn = _model(rng)
    ref_acc, ref_w = jsw.SlidingWindowInference(
        jax_fn, PATCH_2D, STRIDE_2D, BATCH, CLASSES, blend_impl="xla",
        gaussian_blend=gaussian, slice_stacked=True)(variables, volume)
    assert ref_acc.shape == STACK[:3] + (CLASSES,)
    outs = {}
    for impl in ("pallas", "xla"):
        acc, w = tsw.SlidingWindowInference(
            port_fn, PATCH_2D, STRIDE_2D, BATCH, CLASSES, blend_impl=impl,
            gaussian_blend=gaussian, slice_stacked=True, device="cpu")(volume)
        outs[impl] = (acc.numpy(), w.numpy())
        np.testing.assert_allclose(outs[impl][0], np.asarray(ref_acc), **TOL)
        np.testing.assert_allclose(outs[impl][1], np.asarray(ref_w), **TOL)
    for a, b in zip(outs["pallas"], outs["xla"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gaussian", [False, True])
def test_rank2_per_slice_matches_jax(gaussian, rng):
    """The per-slice 2D engine (one ``(H, W, C)`` plane) against JAX's
    rank-2 engine, and against the stacked engine on a stack of one."""
    plane = rng.normal(size=STACK[1:]).astype(np.float32)
    variables, jax_fn, port_fn = _model(rng)
    ref_acc, ref_w = jsw.SlidingWindowInference(
        jax_fn, PATCH_2D, STRIDE_2D, BATCH, CLASSES,
        gaussian_blend=gaussian)(variables, plane)
    acc, w = tsw.SlidingWindowInference(
        port_fn, PATCH_2D, STRIDE_2D, BATCH, CLASSES,
        gaussian_blend=gaussian, device="cpu")(plane)
    assert acc.shape == STACK[1:3] + (CLASSES,) and w.shape == STACK[1:3]
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)
    sacc, sw = tsw.SlidingWindowInference(
        port_fn, PATCH_2D, STRIDE_2D, BATCH, CLASSES,
        gaussian_blend=gaussian, slice_stacked=True, device="cpu")(
            plane[None])
    np.testing.assert_array_equal(sacc[0].numpy(), acc.numpy())
    np.testing.assert_array_equal(sw[0].numpy(), w.numpy())


def test_slice_stacked_refusals():
    with pytest.raises(ValueError, match="hard_accumulate"):
        tsw.SlidingWindowInference(lambda p: p, PATCH_2D, STRIDE_2D, BATCH,
                                   CLASSES, hard_accumulate=True,
                                   slice_stacked=True, device="cpu")
    with pytest.raises(ValueError, match="2D patch"):
        tsw.SlidingWindowInference(lambda p: p, PATCH, STRIDE, BATCH,
                                   CLASSES, slice_stacked=True, device="cpu")
    engine = tsw.SlidingWindowInference(lambda p: p, PATCH_2D, STRIDE_2D,
                                        BATCH, CLASSES, slice_stacked=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="smaller than patch"):
        engine(np.zeros((3, 7, 8, 1), np.float32))
