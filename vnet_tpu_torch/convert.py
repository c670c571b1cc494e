"""Weights between the JAX package and the port.

flax variables (``{"params": ..., "batch_stats": ...}``, nested dicts of
arrays) map to a port ``state_dict`` path by path: the port's sub-module
names mirror the flax module names, and only the leaf names and the
convolution layouts change.

| flax leaf | port leaf | layout |
| --- | --- | --- |
| ``.../kernel`` (conv) | ``weight`` | ``(k..., I, O)`` -> ``(O, I, k...)`` |
| ``deconv/kernel`` | ``weight`` | spatial flip, then ``(I, O, k...)`` |
| ``scale``, ``prelu/alpha`` | ``weight`` | — |
| ``bias`` | ``bias`` | — |
| ``batch_stats .../mean``, ``var`` | ``running_mean``, ``running_var`` | — |

The layouts are rank-generic: a 2D kernel is HWIO <-> OIHW, a 3D one DHWIO
<-> OIDHW, a dense kernel (the ``Dense`` network's ``dense_i``,
``output_dense``) ``(in, out)`` <-> ``nn.Linear``'s ``(out, in)``; a kernel
is any leaf of rank 2 or more (every other leaf is a per-channel vector).
Names carry over as they are, ``pre_norm_i`` (``VNetLegacy``) and
``concat_norm`` (``UNet``) among them. A packed network has the variables
of a direct one, so one checkpoint serves both. The transpose convolution needs the
flip, over its spatial axes only, because ``lax.conv_transpose`` does not
flip its kernel while ``F.conv_transpose3d`` (or ``2d``) is the adjoint of a
convolution; with the port's ``(in, out, ...)`` weight layout that is a
flip plus the in/out order of a transpose weight.

Gradients map like the parameters they belong to (:func:`flax_to_grads`,
:func:`grads_to_flax`), and so do Adam's moments: optax's
``ScaleByAdamState`` ``mu`` / ``nu`` / ``count`` are ``torch.optim.Adam``'s
``exp_avg`` / ``exp_avg_sq`` / ``step`` (:func:`adam_state_from_optax`,
:func:`adam_state_to_optax`), so an optimizer state carries across.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_TO_PORT = {"kernel": "weight", "scale": "weight", "alpha": "weight",
            "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def kernel_to_torch(kernel: np.ndarray, transpose: bool) -> np.ndarray:
    """``(*k, I, O)`` conv kernel (HWIO, DHWIO; a dense ``(I, O)``) ->
    ``F.conv2d`` / ``F.conv3d``'s ``(O, I, *k)`` or, for a transpose
    convolution,
    ``F.conv_transpose2d`` / ``3d``'s ``(I, O, *k)``, spatially flipped."""
    spatial = tuple(range(kernel.ndim - 2))
    i, o = kernel.ndim - 2, kernel.ndim - 1
    if transpose:
        return np.flip(kernel, spatial).transpose(i, o, *spatial)
    return kernel.transpose(o, i, *spatial)


def kernel_to_flax(weight: np.ndarray, transpose: bool) -> np.ndarray:
    """Inverse of :func:`kernel_to_torch`."""
    spatial = tuple(range(weight.ndim - 2))
    k = tuple(range(2, weight.ndim))
    if transpose:
        return np.flip(weight.transpose(*k, 0, 1), spatial)
    return weight.transpose(*k, 1, 0)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``batch_stats`` (arrays) -> port ``state_dict``."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                arr = kernel_to_torch(
                    arr, transpose=path[-2:-1] == ("deconv",))
            key = ".".join(path[:-1] + (_TO_PORT[path[-1]],))
            out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Port ``state_dict`` -> ``{"params": ..., "batch_stats": ...}`` of
    nested dicts of numpy arrays (the inverse of
    :func:`flax_to_state_dict`)."""
    out = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        path = tuple(key.split("."))
        arr = tensor.detach().cpu().float().numpy()
        leaf = path[-1]
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            collection, name = "params", "bias"
        elif arr.ndim >= 2:  # a convolution's or a dense layer's kernel
            collection, name = "params", "kernel"
            arr = kernel_to_flax(arr, transpose=path[-2:-1] == ("deconv",))
        else:
            collection = "params"
            name = "alpha" if path[-2:-1] == ("prelu",) else "scale"
        node = out[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def flax_to_grads(grads: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter-shaped tree (gradients) -> ``{port name: tensor}``."""
    return flax_to_state_dict({"params": grads})


def grads_to_flax(grads: Mapping[str, torch.Tensor]) -> dict:
    """``{port parameter name: tensor}`` -> flax ``params``-shaped tree."""
    return state_dict_to_flax(grads)["params"]


def _adam_leaf(opt_state):
    """optax's ``ScaleByAdamState`` inside an optimizer state (a tuple of
    transformation states)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_leaf(part)
            if found is not None:
                return found
    return None


def adam_state_from_optax(optimizer: torch.optim.Optimizer,
                          network: nn.Module, opt_state) -> None:
    """Load an optax Adam state into ``optimizer`` (a ``torch.optim.Adam``
    over ``network.parameters()``): ``mu`` -> ``exp_avg``, ``nu`` ->
    ``exp_avg_sq``, ``count`` -> ``step``."""
    adam = _adam_leaf(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (mu, nu) in opt_state")
    mu, nu = flax_to_grads(adam.mu), flax_to_grads(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    for name, p in network.named_parameters():
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype)}


def adam_state_to_optax(optimizer: torch.optim.Optimizer,
                        network: nn.Module) -> dict:
    """``{"count", "mu", "nu"}`` (numpy, flax layouts) of a
    ``torch.optim.Adam`` over ``network.parameters()``."""
    named = dict(network.named_parameters())
    states = [optimizer.state[p] for p in named.values()]
    return {"count": int(states[0]["step"]),
            "mu": grads_to_flax({n: s["exp_avg"]
                                 for n, s in zip(named, states)}),
            "nu": grads_to_flax({n: s["exp_avg_sq"]
                                 for n, s in zip(named, states)})}
