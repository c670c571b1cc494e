"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

Variables for a flax module are made from ``jax.eval_shape`` of its init
(no compilation) and filled from a numpy generator, so JAX and the port get
the same numbers: Xavier-uniform kernels, and randomised scales, biases,
PReLU slopes and running statistics, so that every variable matters.
The training-step helpers hold the port's logits, gradients and running
averages against JAX's (or against another port network's) at ``rtol``
and ``atol`` a fraction of the largest entry of their kind (1e-4 by
default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)


def _fill(path, shape, rng):
    name = path[-1]
    if name == "kernel":
        rf = int(np.prod(shape[:-2]))
        lim = np.sqrt(6.0 / (rf * (shape[-2] + shape[-1])))
        return rng.uniform(-lim, lim, shape)
    if name in ("scale", "var"):
        return rng.uniform(0.7, 1.4, shape)
    if name == "alpha":
        return rng.uniform(0.05, 0.3, shape)
    return rng.normal(0.0, 0.1, shape)  # bias, mean


def random_variables(module, rng, *args, **kwargs):
    """Random numpy variables with the structure of ``module.init``."""
    shapes = jax.eval_shape(
        lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))

    def walk(tree, path):
        if hasattr(tree, "shape"):
            return _fill(path, tree.shape, rng).astype(np.float32)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(shapes, ())


def jax_apply(module, variables, *args, **kwargs):
    """Jitted ``module.apply`` with the batch-stats collection mutable (the
    EMA write flax performs under batch statistics is discarded)."""
    fn = jax.jit(lambda v, *a: module.apply(
        v, *a, mutable=["batch_stats"], **kwargs)[0])
    return np.asarray(fn(variables, *args))


def to_port(x: np.ndarray) -> torch.Tensor:
    """``(B, *spatial, C)`` numpy -> the port's ``(B, C, *spatial)`` view."""
    n = x.ndim
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, n - 1, *range(1, n - 1))


def from_port(y: torch.Tensor) -> np.ndarray:
    return y.detach().permute(0, *range(2, y.ndim), 1).float().numpy()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_close(got, ref, what, rtol=1e-4, atol_fraction=1e-4):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys(), what
    atol = atol_fraction * max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {key}")


def jax_train(net, variables, x, cot):
    """Logits, parameter gradients of ``sum(logits * cot)`` and the
    updated running averages of one training-mode forward, jitted."""
    def loss(params):
        out, mutated = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot)), (out, mutated["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    return np.asarray(out), jax.device_get(grads), jax.device_get(stats)


def port_train(net, variables, x, cot, dropout_seed=0):
    """:func:`jax_train` of a port network loaded with ``variables``."""
    net.load_state_dict(flax_to_state_dict(variables), strict=True)
    net.train()
    out = net(torch.from_numpy(x), dropout_seed=dropout_seed)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = grads_to_flax({k: p.grad for k, p in net.named_parameters()})
    stats = state_dict_to_flax(
        {k: v for k, v in net.state_dict().items()
         if k.endswith(("running_mean", "running_var"))})["batch_stats"]
    return out.detach().numpy(), grads, stats


def assert_logits_close(got, ref, rtol=1e-4, atol_fraction=1e-4):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_fraction * scale)
