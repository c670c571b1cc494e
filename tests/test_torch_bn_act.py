"""The fused batch norm + activation (``ops/bn_act.py``) on the CPU, where
its passes are their plain versions: ``Norm(x, groups, act=...)`` against
autograd of the eager chain it replaced (``BatchNorm.eager``, then the
``Activation``), packed and direct, rank 2 and 3, each activation, train
and eval: outputs and running averages bitwise, gradients of the input,
the affine and PReLU's slope within float32 rounding, and no running
average update in a block's recompute. ``tests/test_torch_cuda_bn_act.py``
holds the kernels against these plain versions on the card."""

import copy

import pytest
import torch

from vnet_tpu_torch.models import layers as tl
from vnet_tpu_torch.ops import bn_act as ba

C = 3
# float32: the closed-form backward against autograd of the chain, summed
# in other orders; max |diff| relative to the chain's max |grad|
GRAD_RTOL = 1e-5


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _modules(act: str, seed: int):
    gen = torch.Generator().manual_seed(seed)
    norm = tl.Norm("batch", C)
    am = tl.Activation(act, C) if act != "none" else None
    with torch.no_grad():
        norm.bn.weight.uniform_(0.5, 1.5, generator=gen)
        norm.bn.bias.normal_(generator=gen)
        norm.bn.running_mean.normal_(generator=gen)
        norm.bn.running_var.uniform_(0.5, 2.0, generator=gen)
        if act == "prelu":
            am.prelu.weight.uniform_(-0.5, 0.5, generator=gen)
    return norm, am


def _params(norm, am):
    return [norm.bn.weight, norm.bn.bias] + (
        [am.prelu.weight] if am is not None and am.kind == "prelu" else [])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("act", ["prelu", "relu", "lrelu", "none"])
@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("packed", [False, True],
                         ids=["direct", "packed"])
def test_fused_norm_act_matches_eager_chain(packed, rank, act, train,
                                            one_thread):
    groups = 2 ** rank if packed else 1
    gen = torch.Generator().manual_seed(rank * 10 + len(act))
    fmt = torch.channels_last_3d if rank == 3 else torch.channels_last
    x = (torch.randn((2, groups * C) + (4,) * rank, generator=gen) * 2
         + 0.5).contiguous(memory_format=fmt)
    cot = torch.randn(x.shape, generator=gen)
    norm, am = _modules(act, seed=rank + 7 * groups)
    ref, ref_am = copy.deepcopy(norm), copy.deepcopy(am)
    norm.train(train)
    ref.train(train)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = norm(xa, groups, act=am)
    y_ref = ref.bn.eager(xb, not train, groups)
    if ref_am is not None:
        y_ref = ref_am(y_ref, groups)
    assert torch.equal(y, y_ref)
    assert y.is_contiguous(memory_format=fmt)
    for buf in ("running_mean", "running_var"):
        assert torch.equal(getattr(norm.bn, buf), getattr(ref.bn, buf))
    got = torch.autograd.grad((y * cot).sum(), [xa] + _params(norm, am))
    want = torch.autograd.grad((y_ref * cot).sum(),
                               [xb] + _params(ref, ref_am))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=GRAD_RTOL * float(w.abs().max()))
    # a block's recompute computes the same output and leaves the running
    # averages where the forward put them
    before = [b.clone() for b in (norm.bn.running_mean, norm.bn.running_var)]
    token = tl._RECOMPUTING.set(True)
    try:
        again = norm(x, groups, act=am)
    finally:
        tl._RECOMPUTING.reset(token)
    assert torch.equal(again, y)
    assert torch.equal(norm.bn.running_mean, before[0])
    assert torch.equal(norm.bn.running_var, before[1])


def test_bad_arguments_raise():
    x = torch.zeros(2, 6, 4, 4)
    w = torch.ones(3)
    with pytest.raises(ValueError, match="channels"):
        ba.batch_norm_act(x, w, w, w, w, groups=4)
    with pytest.raises(ValueError, match="activation"):
        ba.batch_norm_act(x, w, w, w, w, groups=2, act="gelu")
    with pytest.raises(ValueError, match="alpha"):
        ba.batch_norm_act(x, w, w, w, w, groups=2, act="prelu")
    with pytest.raises(ValueError, match="update"):
        ba.batch_norm_act(x, w, w, w, w, groups=2, batch=False, update=True)
