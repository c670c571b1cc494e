"""The custom-backward BatchNorm (``ops/batchnorm.py``) on the card: with
``STATS_IMPL = "pallas"`` it launches the statistics kernels once forward
and once backward and agrees with ``"xla"``.

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
``tests/test_torch_batchnorm.py`` holds both switches against the JAX
package on the CPU with the inputs below.
"""

import numpy as np
import pytest
import torch

from vnet_tpu_torch.ops import batchnorm as bn
from vnet_tpu_torch.ops.fused import bn_grad_stats, bn_stats

C = 4


def _inputs(groups, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 6, 6, groups * C)).astype(np.float32)
    scale = rng.normal(size=(C,)).astype(np.float32) + 1.5
    bias = rng.normal(size=(C,)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    return x, scale, bias, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the statistics kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 8])
def test_pallas_switch_launches_kernels_on_card(groups, monkeypatch,
                                                cuda_device):
    x, scale, bias, w = _inputs(groups, seed=5)
    out = {}
    for impl in ("xla", "pallas"):
        monkeypatch.setattr(bn, "STATS_IMPL", impl)
        ts = [torch.from_numpy(a).to(cuda_device).requires_grad_()
              for a in (x, scale, bias)]
        before = (bn_stats.launches, bn_grad_stats.launches)
        y, mean, var = bn.batch_norm_train(*ts, 0.0, groups)
        loss = ((y * torch.from_numpy(w).to(cuda_device)).sum()
                + 0.3 * mean.sum() + 0.7 * var.sum())
        grads = torch.autograd.grad(loss, ts)
        launched = (bn_stats.launches - before[0],
                    bn_grad_stats.launches - before[1])
        assert launched == ((1, 1) if impl == "pallas" else (0, 0))
        out[impl] = [t.detach().cpu() for t in (y, mean, var) + grads]
    for a, b in zip(out["pallas"], out["xla"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
