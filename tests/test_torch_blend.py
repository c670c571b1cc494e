"""The port's blend accumulate against the JAX Pallas kernel.

On the CPU the wrapper runs the plain version (a loop of slice-adds in
patch order); it must equal ``blend_accumulate_patches`` of the JAX
package, run in interpret mode, exactly: both add the same float32 values
in the same order. The CUDA kernel itself needs a card and is compared
with the plain version there (``chip_smoke.py`` phase 2, and the ``cuda``
test below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.infer.sliding_window import build_patch_grid
from vnet_tpu.ops.pallas import blend_accumulate_patches as jax_blend
from vnet_tpu_torch.ops import build
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


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_equals_jax_pallas_interpret(name, rng):
    acc, contrib, starts = _case(name, rng)
    # the JAX kernel slices every axis, the channel axis from start 0
    starts4 = np.concatenate([starts, np.zeros((len(starts), 1), np.int32)],
                             axis=1)
    ref = np.asarray(jax_blend(jnp.asarray(acc), jnp.asarray(contrib),
                               jnp.asarray(starts4), interpret=True))
    before = blend_accumulate_patches.launches
    out = blend_accumulate_patches(torch.from_numpy(acc.copy()),
                                   torch.from_numpy(contrib),
                                   torch.from_numpy(starts)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert blend_accumulate_patches.launches == before  # CPU: no launch


def test_plain_is_in_place_and_ordered(rng):
    acc, contrib, starts = _case("overlap", rng)
    acc_t = torch.from_numpy(acc.copy())
    out = blend_accumulate_plain(acc_t, torch.from_numpy(contrib),
                                 torch.from_numpy(starts))
    assert out is acc_t
    expect = acc.copy()
    p = contrib.shape[1:4]
    for b, (x, y, z) in enumerate(starts):
        expect[x:x + p[0], y:y + p[1], z:z + p[2]] += contrib[b]
    np.testing.assert_array_equal(out.numpy(), expect)


def _bad_args(kind, rng):
    acc, contrib, starts = _case("overlap", rng)
    acc, contrib = torch.from_numpy(acc), torch.from_numpy(contrib)
    starts = torch.from_numpy(starts)
    if kind == "dtype":
        acc = acc.double()
    elif kind == "channels":
        contrib = contrib[..., :2].contiguous()
    elif kind == "noncontiguous":
        acc = acc.transpose(0, 1)
    elif kind == "starts_dtype":
        starts = starts.long()
    elif kind == "starts_range":
        starts = starts.clone()
        starts[-1, 0] += 1
    elif kind == "starts_negative":
        starts = starts.clone()
        starts[0, 2] = -1
    return acc, contrib, starts


@pytest.mark.parametrize("kind", ["dtype", "channels", "noncontiguous",
                                  "starts_dtype", "starts_range",
                                  "starts_negative"])
def test_wrapper_rejects_bad_arguments(kind, rng):
    with pytest.raises((TypeError, ValueError)):
        blend_accumulate_patches(*_bad_args(kind, rng))


def test_wrapper_never_falls_back_off_the_cpu(rng):
    """A tensor that is not on the CPU never takes the plain version."""
    acc, contrib, starts = _case("overlap", rng)
    with pytest.raises(ValueError, match="unsupported device"):
        blend_accumulate_patches(torch.empty(acc.shape, device="meta"),
                                 torch.empty(contrib.shape, device="meta"),
                                 torch.from_numpy(starts))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os, "access", lambda *_a: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()


def test_build_dir_is_in_the_checkout_when_writable():
    assert build.build_dir() == build.PACKAGE_DIR / "_build"


def test_build_dir_falls_back_to_user_cache(monkeypatch, tmp_path):
    """A read-only package directory (an installed wheel) builds into the
    per-user cache instead."""
    monkeypatch.setattr(build.os, "access", lambda *_a: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert build.build_dir() == tmp_path / "vnet_tpu_torch"


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
