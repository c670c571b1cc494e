"""Optimizers and the learning-rate schedule — counterpart of
``vnet_tpu/train/optim.py``.

Exponential decay ``lr = init * factor^(count / steps)`` (optax's
non-staircase ``exponential_decay``) feeding SGD, Adam, Momentum or
NesterovMomentum, with optax's semantics: the schedule is read at the
optimizer's count *before* the step increments it, so the first step trains
at ``lr(0)`` (:func:`set_learning_rate` is called with the step number
before each ``optimizer.step()``). Adam is ``torch.optim.Adam`` with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added after the square root);
``FusedAdam``, the JAX package's raveled Adam, is the same math and maps to
it. Momentum is optax's trace (``t = g + m * t``), which is
``torch.optim.SGD``'s buffer with no dampening.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from ..config import OptimizerConfig

OPTIMIZER_NAMES = ("SGD", "Adam", "Momentum", "NesterovMomentum",
                   "FusedAdam")


def learning_rate_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    init, factor, steps = (cfg.initial_learning_rate, cfg.decay_factor,
                           cfg.decay_steps)
    return lambda count: init * factor ** (count / steps)


def build_optimizer(cfg: OptimizerConfig, params: Iterable[torch.Tensor]
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """``(optimizer, schedule)``; raises on unknown names."""
    schedule = learning_rate_schedule(cfg)
    lr = schedule(0)
    if cfg.name == "SGD":
        opt = torch.optim.SGD(params, lr=lr)
    elif cfg.name in ("Adam", "FusedAdam"):
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif cfg.name == "Momentum":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    elif cfg.name == "NesterovMomentum":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                              nesterov=True)
    else:
        raise ValueError(f"Invalid optimizer: {cfg.name!r}")
    return opt, schedule


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      schedule: Callable[[int], float], count: int) -> float:
    """Set every group's learning rate to ``schedule(count)``; returns it."""
    lr = schedule(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    return lr
