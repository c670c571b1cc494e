"""The dropout kernel (``csrc/dropout.cu``) against its plain version on
the card: bitwise equal for every flavour and dtype, the ``xla`` survivors
``x / keep_d`` rounded once (``keep_d``: the keep probability rounded to
the dtype).

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
"""

import pytest
import torch

from vnet_tpu_torch.ops.dropout import (dropout_apply, dropout_params,
                                        dropout_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the dropout kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "bits8", "xla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_equals_plain_on_card(impl, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn((3, 16, 9, 8, 7), generator=gen, device=cuda_device)
         * 30.0).to(dtype)
    params = dropout_params(0.3, impl)
    before = dropout_apply.launches
    out_k = dropout_apply(x, 123, 4, *params)
    out_p = dropout_plain(x, 123, 4, *params)
    torch.cuda.synchronize()
    assert dropout_apply.launches == before + 1
    assert torch.equal(out_k, out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_xla_survivors_are_one_rounded_division_on_card(dtype, cuda_device):
    """Ragged length (not a multiple of 4) and an unaligned start: the
    kernel's scalar path gives ``dtype(f32(x) / f32(keep_d))`` too."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn(4099, generator=gen, device=cuda_device) * 30.0).to(
        dtype)[1:]
    thr, keep, divide = dropout_params(0.01, "xla")
    assert divide
    out = dropout_apply(x, 7, 2, thr, keep, divide)
    keep_d = torch.tensor(keep, dtype=dtype).float().to(cuda_device)
    expect = (x.float() / keep_d).to(dtype)
    kept = out != 0
    assert kept.float().mean().item() > 0.95
    assert torch.equal(out[kept], expect[kept])
