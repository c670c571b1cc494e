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
