"""The port's optimizers and schedule against optax, float32.

Each optimizer of the config takes K = 4 steps in optax and in the port on
the same numpy gradients, from the same parameters, with the schedule read
at the pre-increment count. The update is the same elementwise formula on
each side, but torch computes the learning rate and Adam's bias corrections
in float64 and optax in float32, so parameters (of order 1) agree to a few
float32 ulps: ``rtol = 1e-5``, ``atol = 1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnet_tpu.config import OptimizerConfig as JaxOptimizerConfig
from vnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from vnet_tpu_torch.config import OptimizerConfig
from vnet_tpu_torch.train.optim import (OPTIMIZER_NAMES, build_optimizer,
                                        set_learning_rate)

K = 4
TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(initial_learning_rate=0.05, momentum=0.9, decay_factor=0.5,
           decay_steps=2)


@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_k_steps_match_optax(name, rng):
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(K)]

    tx, _ = jax_build_optimizer(JaxOptimizerConfig(name=name, **CFG))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, schedule = build_optimizer(OptimizerConfig(name=name, **CFG),
                                    list(tp.values()))
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        set_learning_rate(opt, schedule, step)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   **TOL, err_msg=k)


def test_fused_adam_is_adam():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt, _ = build_optimizer(OptimizerConfig(name="FusedAdam"), p)
    assert type(opt) is torch.optim.Adam


def test_schedule_values_match_optax():
    cfg = dict(initial_learning_rate=1e-2, decay_factor=0.99, decay_steps=100)
    _, jax_schedule = jax_build_optimizer(JaxOptimizerConfig(**cfg))
    _, schedule = build_optimizer(OptimizerConfig(**cfg),
                                  [torch.nn.Parameter(torch.zeros(1))])
    assert schedule(0) == 1e-2
    for count in (0, 1, 50, 100, 1234, 15000):
        # optax evaluates the power in float32, the port in float64
        np.testing.assert_allclose(schedule(count),
                                   float(jax_schedule(count)), rtol=1e-5)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Invalid optimizer"):
        build_optimizer(OptimizerConfig(name="LAMB"),
                        [torch.nn.Parameter(torch.zeros(1))])
