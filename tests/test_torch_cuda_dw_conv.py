"""The dW kernel (``csrc/dw_conv.cu``) against its plain version on the
card: within ``RTOL * max|dW|`` (sums of the same products in another
order) and bitwise equal from run to run, in every regime (narrow and wide
tensor-core tiles, the CUDA-core kernel), dtype and layout of ``g``.

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
"""

import pytest
import torch

from vnet_tpu_torch.ops.dw_conv import dw_conv, dw_conv_plain

RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the dW kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,dtype,g_cl", [
    ((2, 9, 8, 7, 16, 16), 5, torch.bfloat16, True),     # narrow, ragged
    ((2, 8, 8, 8, 32, 16), 5, torch.bfloat16, True),     # narrow
    ((3, 9, 11, 13, 32, 32), 5, torch.bfloat16, True),   # wide, ragged
    ((2, 4, 4, 4, 256, 256), 5, torch.bfloat16, True),   # wide
    ((2, 8, 8, 8, 16, 3), 1, torch.bfloat16, True),      # CUDA cores
    ((2, 6, 10, 16, 32, 16), 5, torch.float16, True),
    ((2, 5, 6, 7, 16, 16), 3, torch.float32, True),      # CUDA cores
    ((2, 7, 9, 11, 16, 32), 5, torch.bfloat16, False),   # g not CL
])
def test_kernel_equals_plain_on_card(shape, k, dtype, g_cl, cuda_device):
    b, x, y, z, ci, co = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cl = torch.channels_last_3d
    xt = torch.randn((b, ci, x, y, z), generator=gen, device=cuda_device
                     ).to(dtype).contiguous(memory_format=cl)
    gt = torch.randn((b, co, x, y, z), generator=gen, device=cuda_device
                     ).to(dtype)
    if g_cl:
        gt = gt.contiguous(memory_format=cl)
    before = dw_conv.launches
    got = dw_conv(xt, gt, (k,) * 3)
    again = dw_conv(xt, gt, (k,) * 3)
    ref = dw_conv_plain(xt, gt, (k,) * 3)
    torch.cuda.synchronize()
    assert dw_conv.launches == before + 2
    assert torch.equal(got, again)  # bitwise from run to run
    torch.testing.assert_close(got, ref, rtol=RTOL,
                               atol=RTOL * ref.abs().max().item())
