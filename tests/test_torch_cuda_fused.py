"""The BatchNorm statistics, fused tail and row blend kernels
(``csrc/bn_stats.cu``, ``csrc/bias_prelu_residual.cu``,
``csrc/blend_rows.cu``) against their plain versions on the card, and no
fallback to a plain version when a library cannot load.

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
``tests/test_torch_fused.py`` holds the plain versions against the JAX
kernels on the CPU with the inputs below.
"""

import numpy as np
import pytest
import torch

from vnet_tpu_torch.ops import blend, build, fused
from vnet_tpu_torch.ops.blend import (blend_accumulate_rows,
                                      blend_accumulate_rows_plain)
from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_grad_stats_plain,
                                      bn_stats, bn_stats_plain,
                                      fused_bias_prelu_residual,
                                      fused_bias_prelu_residual_plain)

ROW_CASES = {
    # test_pallas.py's segments
    "pallas_test": (64, 3, 8, [0, 8, 4, 40, 56]),
    # overlapping and duplicated starts, the last segment flush with R
    "overlap_dup": (61, 2, 7, [0, 3, 3, 10, 5, 54, 3, 0, 50, 54]),
}


def _tail_inputs(rng, shape, dtype):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    alpha = np.full((c,), 0.1, np.float32)
    alpha[::2] = 0.25
    conv = (lambda a: torch.from_numpy(a).to(dtype))
    return [conv(a) for a in (x, res, bias, alpha)]


def _row_inputs(rng, big_r, c, r, starts):
    n = len(starts)
    acc = rng.random((big_r, c)).astype(np.float32)
    weight = rng.random((big_r, 1)).astype(np.float32)
    probs = rng.random((n, r, c)).astype(np.float32)
    window = (rng.random((r, 1)) + 0.5).astype(np.float32)
    return acc, weight, probs, window, np.asarray(starts, np.int32)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(4, 9, 16), (3, 7, 5, 3), (2, 3, 2056)])
def test_bn_kernels_match_plain_on_card(shape, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    c = shape[-1]
    mean = torch.randn(c, generator=gen, device=cuda_device) * 0.1
    inv = torch.rand(c, generator=gen, device=cuda_device) + 0.5
    before = (bn_stats.launches, bn_grad_stats.launches)
    got = bn_stats(x) + bn_grad_stats(dy, x, mean, inv)
    ref = bn_stats_plain(x) + bn_grad_stats_plain(dy, x, mean, inv)
    again = bn_stats(x) + bn_grad_stats(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (bn_stats.launches, bn_grad_stats.launches) == (before[0] + 2,
                                                           before[1] + 2)
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean) * inv
    for k, terms in enumerate((xf, xf * xf, dyf, dyf * xhat)):
        bound = 1e-5 * terms.abs().reshape(-1, c).sum(0)
        assert bool(((got[k] - ref[k]).abs() <= bound).all())
        assert torch.equal(got[k], again[k])  # reproducible


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (5, 7, 3)])
def test_tail_kernel_equals_plain_on_card(shape, dtype, rng, cuda_device):
    args = [t.to(cuda_device) for t in _tail_inputs(rng, shape, dtype)]
    before = fused_bias_prelu_residual.launches
    got = fused_bias_prelu_residual(*args)
    ref = fused_bias_prelu_residual_plain(*args)
    torch.cuda.synchronize()
    assert fused_bias_prelu_residual.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_rows_kernel_equals_plain_on_card(name, rng, cuda_device):
    acc, weight, probs, window, starts = _row_inputs(rng, *ROW_CASES[name])
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (acc, weight, probs, window)]
    ref_acc, ref_w = dev[0].clone(), dev[1].clone()
    st = torch.from_numpy(starts)
    before = blend_accumulate_rows.launches
    blend_accumulate_rows(*dev, st)
    blend_accumulate_rows_plain(ref_acc, ref_w, dev[2], dev[3], st)
    torch.cuda.synchronize()
    assert blend_accumulate_rows.launches == before + 1  # any overlap depth
    assert torch.equal(dev[0], ref_acc) and torch.equal(dev[1], ref_w)


@pytest.mark.cuda
@pytest.mark.parametrize("r,c", [(300, 3), (300, 10), (1000, 2)])
def test_rows_kernel_long_segments_on_card(r, c, rng, cuda_device):
    """Segments longer than 256 rows (the tile grows past the block) and
    more channels than one pass holds, with duplicated starts and one
    segment flush with R."""
    big_r = 5 * r + 17
    starts = rng.integers(0, big_r - r + 1, size=40)
    starts[1::3] = starts[0]
    starts[-1] = big_r - r
    acc, weight, probs, window, starts = _row_inputs(rng, big_r, c, r,
                                                     starts)
    dev = [torch.from_numpy(a).to(cuda_device)
           for a in (acc, weight, probs, window)]
    ref_acc, ref_w = dev[0].clone(), dev[1].clone()
    st = torch.from_numpy(starts)
    before = blend_accumulate_rows.launches
    blend_accumulate_rows(*dev, st)
    blend_accumulate_rows_plain(ref_acc, ref_w, dev[2], dev[3], st)
    torch.cuda.synchronize()
    assert blend_accumulate_rows.launches == before + 1
    assert torch.equal(dev[0], ref_acc) and torch.equal(dev[1], ref_w)


@pytest.mark.cuda
def test_rows_kernel_no_segments_launches_nothing(cuda_device):
    acc = torch.ones((64, 3), device=cuda_device)
    before = blend_accumulate_rows.launches
    blend_accumulate_rows(acc, torch.ones((64, 1), device=cuda_device),
                          torch.ones((0, 8, 3), device=cuda_device),
                          torch.ones((8, 1), device=cuda_device),
                          torch.zeros(0, dtype=torch.int32))
    assert blend_accumulate_rows.launches == before
    assert bool((acc == 1).all())


@pytest.mark.cuda
def test_cuda_tensor_raises_when_the_library_cannot_load(monkeypatch,
                                                         cuda_device):
    """No fallback to the plain version on the card."""
    def refuse(name):
        raise build.KernelBuildError(f"refused to build {name}")

    monkeypatch.setattr(build, "load", refuse)
    cached = (fused._lib, fused._tail_kernel, blend._rows_kernel,
              blend._kernel)
    for fn in cached:
        fn.cache_clear()
    x = torch.ones((4, 8), device=cuda_device)
    v = torch.ones((8,), device=cuda_device)
    try:
        with pytest.raises(build.KernelBuildError):
            bn_stats(x)
        with pytest.raises(build.KernelBuildError):
            bn_grad_stats(x, x, v, v)
        with pytest.raises(build.KernelBuildError):
            fused_bias_prelu_residual(x, x, v, v)
        with pytest.raises(build.KernelBuildError):
            blend_accumulate_rows(x, v.reshape(8, 1)[:4], x[None], v[:4, None],
                                  torch.zeros(1, dtype=torch.int32))
        acc = torch.ones((4, 4, 4, 2), device=cuda_device)
        with pytest.raises(build.KernelBuildError):
            blend.blend_accumulate_patches(
                acc, acc[None, :2, :2, :2].contiguous(),
                torch.zeros((1, 3), dtype=torch.int32))
    finally:
        for fn in cached:
            fn.cache_clear()
