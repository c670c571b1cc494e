"""The blend kernel (``csrc/blend_accumulate.cu``) against its plain
version on the card: bitwise equal, as both add the same float32 values in
the same order.

JAX-free (torch, numpy, pytest and the port only), so the card's machine,
which has no JAX, runs it: ``python -m pytest --noconftest -m cuda -q
tests/test_torch_cuda_*.py``. Without a card every test skips.
``tests/test_torch_blend.py`` holds the plain version against the JAX
kernel on the CPU with the geometries below.
"""

import numpy as np
import pytest
import torch

from vnet_tpu_torch.infer.sliding_window import build_patch_grid
from vnet_tpu_torch.ops.blend import (MAX_PATCHES_PER_LAUNCH,
                                      blend_accumulate_patches,
                                      blend_accumulate_plain)

GEOMETRIES = {
    # overlapping on every axis (stride < patch)
    "overlap": ((20, 18, 12), (8, 8, 6), (4, 5, 3), 4),
    # odd extents, clamped last starts, strides that align with nothing
    "ragged_clamped": ((23, 17, 11), (9, 7, 5), (7, 4, 3), 3),
    # average_hard's five channels at starts that keep z * C 4-aligned
    "hard_c5": ((20, 18, 16), (8, 8, 8), (4, 6, 4), 5),
}
# floats per element of the kernel's path: float4 where VZ*C, PZ*C and every
# sz*C are multiples of 4, else float
WIDTHS = {"overlap": 4, "ragged_clamped": 1, "hard_c5": 4}


def _case(name, rng):
    vol, patch, stride, c = GEOMETRIES[name]
    starts = build_patch_grid(vol, patch, stride)
    acc = rng.normal(size=vol + (c,)).astype(np.float32)
    contrib = rng.normal(size=(len(starts),) + patch + (c,)
                         ).astype(np.float32)
    return acc, contrib, starts


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the blend kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _on_card(acc, contrib, starts, device):
    """Kernel and plain version on the card from the same inputs; returns
    both accumulators and the kernel's launches."""
    acc_k = torch.as_tensor(acc).to(device)
    acc_p = acc_k.clone()
    contrib_d = torch.as_tensor(contrib).to(device)
    st = torch.as_tensor(starts, dtype=torch.int32)
    before = blend_accumulate_patches.launches
    blend_accumulate_patches(acc_k, contrib_d, st)
    blend_accumulate_plain(acc_p, contrib_d, st)
    torch.cuda.synchronize()
    return acc_k, acc_p, blend_accumulate_patches.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_equals_plain_on_card(name, rng, cuda_device):
    """The float4 path (C = 4, C = 5 at 4-aligned z * C) and the float
    path (ragged C = 3) are bitwise equal to the slice-adds."""
    acc_k, acc_p, launches = _on_card(*_case(name, rng), cuda_device)
    assert launches == 1
    assert blend_accumulate_patches.last_width == WIDTHS[name]
    assert torch.equal(acc_k, acc_p)


@pytest.mark.cuda
def test_kernel_dense_stride_geometry_on_card(cuda_device):
    """The LiTS geometry the TPU blend could not lower: patch (256, 256, 32)
    at stride 16 on every axis in a (384, 384, 64, 4) accumulator, the
    grid's first 10 patches."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    starts = build_patch_grid((384, 384, 64), (256, 256, 32), (16, 16, 16))
    acc = torch.rand((384, 384, 64, 4), generator=gen, device=cuda_device)
    contrib = torch.rand((10, 256, 256, 32, 4), generator=gen,
                         device=cuda_device)
    acc_k, acc_p, launches = _on_card(acc, contrib, starts[:10], cuda_device)
    assert launches == 1 and blend_accumulate_patches.last_width == 4
    assert torch.equal(acc_k, acc_p)


@pytest.mark.cuda
def test_kernel_splits_many_patches_in_order_on_card(rng, cuda_device):
    """360 overlapping patches take two launches, the second after the
    first: still the slice-adds' bits."""
    starts = build_patch_grid((20, 18, 12), (4, 4, 4), (2, 2, 2))
    assert len(starts) > MAX_PATCHES_PER_LAUNCH
    acc = rng.normal(size=(20, 18, 12, 4)).astype(np.float32)
    contrib = rng.normal(size=(len(starts), 4, 4, 4, 4)).astype(np.float32)
    acc_k, acc_p, launches = _on_card(acc, contrib, starts, cuda_device)
    assert launches == -(-len(starts) // MAX_PATCHES_PER_LAUNCH)
    assert torch.equal(acc_k, acc_p)


def _stacked_rows(stack, patch, stride):
    """``(z, i, j)`` rows of a slice-stacked 2D grid, every z crossed with
    the ``(H, W)`` grid in the sliding window's order."""
    grid = build_patch_grid(stack[1:], patch, stride)
    zs = np.repeat(np.arange(stack[0], dtype=np.int32), len(grid))
    return np.concatenate([zs[:, None], np.tile(grid, (stack[0], 1))], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("stack,patch,stride,c,width", [
    # config_2d.json's evaluation: 384^2 planes, 256^2 patches at stride 256,
    # 1 + 2 channels (weight, two classes)
    ((64, 384, 384), (256, 256), (256, 256), 3, 4),
    # ragged: odd widths, overlapping, clamped last starts
    ((13, 41, 37), (16, 15), (9, 7), 3, 1)])
def test_kernel_slice_stacked_geometry_on_card(stack, patch, stride, c, width,
                                               cuda_device):
    """The 2D evaluation's blend: contributions of depth 1, ``(B, 1, px, py,
    C)``, into a ``(Z, H, W, C)`` accumulator at ``(z, i, j)`` starts; every
    batch of 10 rows (batches straddle slices) bitwise equal to the
    slice-adds, on the path the geometry implies."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rows = _stacked_rows(stack, patch, stride)
    acc_k = torch.rand(stack + (c,), generator=gen, device=cuda_device)
    acc_p = acc_k.clone()
    for lo in range(0, len(rows), 10):
        batch = rows[lo:lo + 10]
        contrib = torch.rand((len(batch), 1) + patch + (c,), generator=gen,
                             device=cuda_device)
        st = torch.as_tensor(batch, dtype=torch.int32)
        blend_accumulate_patches(acc_k, contrib, st)
        assert blend_accumulate_patches.last_width == width
        blend_accumulate_plain(acc_p, contrib, st)
        torch.cuda.synchronize()
        assert torch.equal(acc_k, acc_p), lo


@pytest.mark.cuda
def test_slice_stacked_engine_kernel_equals_plain_on_card(cuda_device):
    """The slice-stacked sliding window with the kernel and with the plain
    slice-adds: the same accumulators, bit for bit."""
    from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference

    w = torch.randn((2, 3), generator=torch.Generator().manual_seed(4)).to(
        cuda_device)

    def model(p):  # logits that depend on the batch, like batch_stats
        return torch.einsum("...c,ck->...k", p - p.mean(), w)

    volume = np.random.default_rng(5).normal(size=(11, 40, 36, 2)).astype(
        np.float32)
    outs = [SlidingWindowInference(model, (16, 16), (9, 7), 6, 3,
                                   gaussian_blend=True, blend_impl=impl,
                                   slice_stacked=True,
                                   device=cuda_device)(volume)
            for impl in ("pallas", "xla")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,stride,stacked", [
    ((40, 36, 24, 1), (16, 16, 8), (12, 10, 8), False),
    ((5, 40, 36, 1), (16, 16), (12, 10), True),
    ((40, 36, 1), (16, 16), (12, 10), False)])
def test_engine_uses_a_resident_tensor_in_place_on_card(shape, patch, stride,
                                                        stacked, cuda_device):
    """A float32 volume already on the card is the engine's volume (the
    same storage, no host round trip, no second copy); a host volume is
    copied there once; both give the numpy path's sums bit for bit, with
    the kernel's blend (3D, slice-stacked and one slice)."""
    from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference

    w = torch.randn((1, 3), generator=torch.Generator().manual_seed(6)).to(
        cuda_device)

    def model(p):
        return torch.einsum("...c,ck->...k", p - p.mean(), w)

    volume = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    engine = SlidingWindowInference(model, patch, stride, 4, 3,
                                    gaussian_blend=True, blend_impl="pallas",
                                    slice_stacked=stacked,
                                    device=cuda_device)
    resident = torch.from_numpy(volume).to(cuda_device)
    assert engine.device_volume(resident).data_ptr() == resident.data_ptr()
    host = torch.from_numpy(volume)
    copied = engine.device_volume(host)
    assert copied.device.type == "cuda" and copied.data_ptr() != \
        host.data_ptr()
    launches = blend_accumulate_patches.launches
    got = engine(resident)
    torch.cuda.synchronize()
    assert blend_accumulate_patches.launches > launches
    ref = engine(volume)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
