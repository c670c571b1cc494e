"""The port's losses and metrics against the JAX package's, float32.

Same numpy logits and labels into ``vnet_tpu.ops.losses.segmentation_loss``
and the port's; values and the gradients with respect to the logits agree
to float32 summation order (``rtol = 1e-5``, ``atol = 1e-6``). Metrics are
ratios of counts and agree to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.ops.losses import LOSS_NAMES as JAX_LOSS_NAMES
from vnet_tpu.ops.losses import segmentation_loss as jax_loss
from vnet_tpu.ops.metrics import batch_metrics as jax_metrics
from vnet_tpu_torch.ops.losses import LOSS_NAMES, segmentation_loss
from vnet_tpu_torch.ops.metrics import batch_metrics

TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(num_classes=3, weights=(0.01, 0.1, 1.0), alpha=0.7)


def _inputs(rng):
    logits = rng.normal(0.0, 2.0, size=(2, 6, 5, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 6, 5, 4)).astype(np.int32)
    return logits, labels


def test_same_names():
    assert LOSS_NAMES == JAX_LOSS_NAMES


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_value_and_gradient(name, rng):
    logits, labels = _inputs(rng)

    def jfn(lg):
        loss, aux = jax_loss(lg, jnp.asarray(labels), name=name, **KW)
        return loss, aux

    (jl, jaux), jg = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    tl, taux = segmentation_loss(lg, torch.from_numpy(labels), name=name,
                                 **KW)
    (tg,) = torch.autograd.grad(tl, lg)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert taux.keys() == jaux.keys()
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **TOL)


def test_unknown_loss_raises(rng):
    logits, labels = _inputs(rng)
    with pytest.raises(ValueError, match="Invalid loss"):
        segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          name="dice", num_classes=3)


@pytest.mark.parametrize("compute_auc", [False, True])
def test_batch_metrics(compute_auc, rng):
    logits, labels = _inputs(rng)
    ref = jax_metrics(jnp.asarray(logits), jnp.asarray(labels), 3,
                      compute_auc=compute_auc)
    out = batch_metrics(torch.from_numpy(logits), torch.from_numpy(labels), 3,
                        compute_auc=compute_auc)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), **TOL,
                                   err_msg=k)
