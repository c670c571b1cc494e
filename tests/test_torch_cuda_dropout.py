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
                                        dropout_plain, keep_mask)


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


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("fmt", ["channels_last", "contiguous"])
def test_2d_activation_kernel_equals_plain_on_card(impl, fmt, cuda_device):
    """A 4-D ``(B, C, H, W)`` activation of the 2D network, bf16: the
    kernel's output is channels-last and bitwise equal to the plain
    version's, survivors of ``xla`` are ``x / keep_d`` rounded once, and the
    backward pass masks a gradient that is not channels-last where the
    forward pass masked."""
    from vnet_tpu_torch.ops.dropout import dropout

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn((4, 16, 40, 36), generator=gen, device=cuda_device)
         * 30.0).to(torch.bfloat16)
    if fmt == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    params = dropout_params(0.1, impl)
    out_k = dropout_apply(x, 99, 5, *params)
    out_p = dropout_plain(x, 99, 5, *params)
    torch.cuda.synchronize()
    assert out_k.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out_k, out_p)
    if impl == "xla":
        keep_d = torch.tensor(params[1], dtype=x.dtype).float().to(
            cuda_device)
        kept = out_k != 0
        assert torch.equal(out_k[kept], (x.float() / keep_d).to(x.dtype)[kept])
    xr = x.detach().requires_grad_()
    y = dropout(xr, 99, 5, 0.1, impl)
    g = torch.ones(y.shape, dtype=y.dtype, device=cuda_device)
    assert not g.is_contiguous(memory_format=torch.channels_last)
    (dx,) = torch.autograd.grad(y, xr, g)
    # an exact 0 in x (torch.randn draws one about once in 2^24) stays 0
    assert bool((((dx != 0) == (y != 0)) | (x == 0)).all())
    assert torch.equal(y, out_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_division_equals_ieee_division_for_every_pattern(
        dtype, cuda_device):
    """Every bf16 or f16 bit pattern through the ``xla`` kernel at each of
    the CPU tests' rates, threshold 2^32 - 1 (every element but those whose
    word is 2^32 - 1 kept): each kept element is ``dtype(f32(x) /
    f32(keep_d))`` bit for bit, NaNs compared as NaN; the kernel divides
    without ``__fdiv_rn`` (``csrc/dropout.cu``)."""
    thr = 2 ** 32 - 1
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=cuda_device).to(torch.int16).view(dtype)
    kept = keep_mask(x.numel(), 11, 4, thr, cuda_device)
    for rate in (0.01, 0.1, 0.3, 0.5, 0.9):
        _, keep, divide = dropout_params(rate, "xla")
        out = dropout_apply(x, 11, 4, thr, keep, divide)
        keep_d = torch.tensor(keep, dtype=dtype).float().to(cuda_device)
        expect = torch.where(kept, (x.float() / keep_d).to(dtype),
                             torch.zeros((), dtype=dtype, device=cuda_device))
        same = ((out.view(torch.int16) == expect.view(torch.int16))
                | (out.isnan() & expect.isnan()))
        assert bool(same.all()), (rate, int((~same).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, 135, 4096 + 2, 96 * 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_with_a_counter_base_equals_plain_on_card(base, dtype,
                                                         cuda_device):
    """A data-parallel rank's counter base, a multiple of 4 (the 16-byte
    path) or not (inside a Philox group: the scalar path), for both
    multiply and divide: bitwise the plain version, which is the global
    mask's rows (``tests/test_torch_dropout.py``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn((2, 16, 9, 8, 7), generator=gen, device=cuda_device)
         * 30.0).to(dtype)
    for impl in ("pallas", "xla"):
        params = dropout_params(0.3, impl)
        out_k = dropout_apply(x, 41, 6, *params, base=base)
        out_p = dropout_plain(x, 41, 6, *params, base=base)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p), (impl, base)
        assert base == 0 or not torch.equal(
            out_k != 0, dropout_apply(x, 41, 6, *params) != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,space", [
    ((2, 16, 8, 8, 8), 2),    # L % 8 == 0: every vector inside one row
    ((3, 4, 12, 3, 1), 4),    # L = 36: a 16-bit vector opens a new row
    ((2, 3, 10, 3, 3), 2),    # L = 135: odd, the scalar loop only
])
def test_kernel_row_map_equals_plain_and_the_global_slab(shape, space, dtype,
                                                         cuda_device):
    """The row-mapped kernel (``L < G``: a space rank's slab of the first
    spatial axis) against its plain version, bitwise, for both multiply and
    divide; joined over the slabs, the whole tensor's mask from the
    contiguous kernel, bitwise."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn(shape, generator=gen, device=cuda_device)
         * 30.0).to(dtype).contiguous(memory_format=torch.channels_last_3d)
    per = shape[2] // space
    for impl in ("pallas", "xla"):
        params = dropout_params(0.3, impl)
        whole = dropout_apply(x, 9, 3, *params, base=64)
        for s in range(space):
            slab = x[:, :, s * per:(s + 1) * per]
            row_len = slab[0].numel()
            key = (9, 3, *params, 64 + s * row_len, row_len,
                   row_len * space)
            out_k = dropout_apply(slab, *key)
            out_p = dropout_plain(slab, *key)
            torch.cuda.synchronize()
            assert torch.equal(out_k, out_p), (impl, s)
            assert torch.equal(out_k, whole[:, :, s * per:(s + 1) * per]), (
                impl, s)
