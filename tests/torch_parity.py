"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

Variables for a flax module are made from ``jax.eval_shape`` of its init
(no compilation) and filled from a numpy generator, so JAX and the port get
the same numbers: Xavier-uniform kernels, and randomised scales, biases,
PReLU slopes and running statistics, so that every variable matters.
"""

import jax
import numpy as np
import torch


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
