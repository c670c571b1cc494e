"""The port's blend accumulate against the JAX Pallas kernel.

On the CPU the wrapper runs the plain version (a loop of slice-adds in
patch order); it must equal ``blend_accumulate_patches`` of the JAX
package, run in interpret mode, exactly: both add the same float32 values
in the same order. The CUDA kernel itself needs a card and is compared
with the plain version there (``chip_smoke.py`` phase 2, and
``tests/test_torch_cuda_blend.py``, which holds the geometries shared with
this module).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_blend import GEOMETRIES, _case
from vnet_tpu.ops.pallas import blend_accumulate_patches as jax_blend
from vnet_tpu_torch.ops import build
from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                      blend_accumulate_plain)

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
