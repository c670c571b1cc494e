"""The fused batch norm + activation kernels (``csrc/bn_act.cu`` beside
``csrc/bn_stats.cu``'s sums, ``ops/bn_act.py``) on the card: each pass against its plain version at the
batch-norm sites of the benchmark's three cells and at small shapes of
every dtype, activation and layout; the Function against the eager chain;
launches a training step; ``export_forward`` on ``cuda``.

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
``tests/test_torch_bn_act.py`` holds the plain versions against the eager
chain on the CPU.
"""

import pytest
import torch

from vnet_tpu_torch.models.layers import Activation, Norm
from vnet_tpu_torch.ops import bn_act as ba
from vnet_tpu_torch.tools import bn_act_bench

# the gradients of the Function against autograd of the eager chain: max
# |diff| relative to the chain's max |grad| (float32 sums of bf16 data in
# other orders; the chain rounds dz to bf16 before its sums, the Function
# does not, and dx is bf16)
GRAD_RTOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def gen(cuda_device):
    return torch.Generator(device=cuda_device).manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(bn_act_bench.CELLS) + ["edge"])
def test_sites_match_plain_on_card(cell, gen):
    """Every distinct batch-norm site of the cell in bf16 at its shape
    (``bn_act_bench.check_site``: the forward's and the gradient's sums to a
    relative 1e-5, apply bitwise given the same sums, dx to one ulp)."""
    if cell == "edge":
        sites, batch = [(s, 0) for s in bn_act_bench.EDGE_SITES], True
    else:
        sites = bn_act_bench.bn_sites(cell)
        batch = bn_act_bench.CELLS[cell][3]
    for (shape, groups, act), _ in sites:
        bn_act_bench.check_site(shape, groups, act, gen, batch)
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("act", list(ba.ACTS))
@pytest.mark.parametrize("shape,groups", [((3, 8, 5, 6, 7), 1),
                                          ((2, 24, 3, 4, 5), 8),
                                          ((4, 12, 9, 10), 4),
                                          ((37, 20), 1),
                                          ((3, 20000), 1)])
def test_small_shapes_match_plain(shape, groups, act, dtype, gen):
    """Ragged extents, the one-channel path (C * size not a multiple of 16),
    rank 2, a ``(B, F)`` input and one of many slabs of channels (the Dense
    network's flattened input), each dtype, train and eval."""
    for batch in (True, False):
        bn_act_bench.check_site(shape, groups, act, gen, batch, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["prelu", "relu", "none"])
@pytest.mark.parametrize("groups", [1, 8])
def test_function_matches_eager_chain(groups, act, gen):
    """``Norm(x, groups, act=...)`` on the kernels against autograd of
    ``BatchNorm.eager`` and the activation, bf16: outputs within two ulps
    and 1e-3 (the sums added in another order move z), gradients
    within GRAD_RTOL,
    running averages within 1e-6."""
    c = 16
    shape = (4, groups * c, 16, 16, 8)
    x, dy, p = bn_act_bench.site_inputs(shape, groups, act, gen)
    mods = []
    for _ in range(2):
        norm = Norm("batch", c).cuda().train()
        am = Activation(act, c).cuda() if act != "none" else None
        with torch.no_grad():
            norm.bn.weight.copy_(p["weight"])
            norm.bn.bias.copy_(p["bias"])
            if act == "prelu":
                am.prelu.weight.copy_(p["alpha"])
        mods.append((norm, am))
    (norm, am), (ref, ref_am) = mods
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    launches = ba.bn_act_apply.launches
    y = norm(xa, groups, act=am)
    assert ba.bn_act_apply.launches == launches + 1
    y_ref = ref.bn.eager(xb, False, groups)
    if ref_am is not None:
        y_ref = ref_am(y_ref, groups)
    diff = (y.detach().float() - y_ref.detach().float()).abs()
    allowed = 2 * torch.finfo(x.dtype).eps * y_ref.detach().float().abs()
    assert bool((diff <= allowed + 1e-3).all())

    def params(n, a):
        return [n.bn.weight, n.bn.bias] + ([a.prelu.weight]
                                           if act == "prelu" else [])

    got = torch.autograd.grad(y, [xa] + params(norm, am), dy)
    want = torch.autograd.grad(y_ref, [xb] + params(ref, ref_am), dy)
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= GRAD_RTOL, err
    for buf in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(norm.bn, buf),
                                   getattr(ref.bn, buf), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("make,remat", [("flagship", True),
                                        ("flagship", False),
                                        ("attention", False)])
def test_training_step_launches_once_per_site_per_pass(make, remat,
                                                        cuda_device):
    """A traced training step (``bn_act_bench.check_step``): the forward's
    sums (``bn_stats``) and apply once per batch-norm call (forward and
    recompute), gradient sums and dx once per forward site; the kernels in the trace are the counted ones,
    and their names carry none of the words the trace groups read as
    other kernels."""
    bn_act_bench.check_step(make, remat)


@pytest.mark.cuda
def test_export_forward_on_cuda(cuda_device):
    """``export_forward`` still exports on the card: the exported network
    is the plain one (no fused kernel in the program) and agrees with the
    module's eval forward, which runs the apply kernel."""
    bn_act_bench.check_export()
