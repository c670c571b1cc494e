"""The port's on-device augmentation (``data/device_aug.py``) against the
JAX package's ``vnet_tpu/data/device_aug.py``.

The random numbers differ by design (a ``torch.Generator`` is not a JAX
key), so the arithmetic is held with the JAX side's own draws: the flip
with JAX's coins and the crop at JAX's index give JAX's arrays exactly;
windowing is deterministic and exact; the noise is held by its mean and
standard deviation. The trainer's extraction of the tail from the host
chain equals the JAX trainer's on the shipped liver pipeline.
"""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu import config as jconfig
from vnet_tpu import data as jdata
from vnet_tpu.data import device_aug as jaug
from vnet_tpu.train.trainer import Trainer as JaxTrainer
from vnet_tpu_torch import config as tconfig
from vnet_tpu_torch import data as tdata
from vnet_tpu_torch.data import device_aug as taug
from vnet_tpu_torch.train.trainer import Trainer, augment_generator

ROOT = Path(__file__).resolve().parent.parent


def test_window_normalize_exact(rng):
    x = rng.normal(100, 200, size=(2, 8, 8, 8, 1)).astype(np.float32)
    ref = np.asarray(jaug.window_normalize(jnp.asarray(x), -50.0, 600.0))
    got = taug.window_normalize(torch.from_numpy(x), -50.0, 600.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axes", [(0,), (0, 2), (1, 2)])
def test_flip_with_jax_coins_exact(axes, rng):
    """Images, labels and distance maps flip together, sample by sample,
    under one coin each (the JAX step flips distance maps with the same
    key)."""
    imgs = rng.normal(size=(8, 6, 5, 4, 2)).astype(np.float32)
    lbls = rng.integers(0, 3, (8, 6, 5, 4)).astype(np.int32)
    dmaps = rng.random((8, 6, 5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ji, jl = jaug.random_flip(key, jnp.asarray(imgs), jnp.asarray(lbls),
                              axes)
    _, jd = jaug.random_flip(key, jnp.asarray(imgs), jnp.asarray(dmaps),
                             axes)
    coins = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, (8,))))
    assert 0 < int(coins.sum()) < 8  # both branches taken
    for x, ref in ((imgs, ji), (lbls, jl), (dmaps, jd)):
        got = taug.flip_where(torch.from_numpy(x), coins, axes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_random_flip_flips_images_and_labels_together(rng):
    imgs = torch.from_numpy(rng.normal(size=(16, 5, 4, 3, 1)).astype(
        np.float32))
    lbls = torch.arange(16 * 60).reshape(16, 5, 4, 3)
    gen = torch.Generator().manual_seed(0)
    fi, fl = taug.random_flip(gen, imgs, lbls, (0,))
    flipped = [not torch.equal(fi[b], imgs[b]) for b in range(16)]
    assert 0 < sum(flipped) < 16
    for b in range(16):
        expect = lbls[b].flip(0) if flipped[b] else lbls[b]
        assert torch.equal(fl[b], expect)


def test_crop_at_jax_index_exact(rng):
    vol = rng.normal(size=(12, 11, 10, 2)).astype(np.float32)
    lbl = rng.integers(0, 2, (12, 11, 10)).astype(np.int32)
    cands = np.array([[0, 0, 0], [3, 2, 1], [4, 5, 6], [9, 9, 9]], np.int32)
    patch = (6, 5, 4)
    key = jax.random.PRNGKey(11)
    ji, jl = jaug.random_crop_from_candidates(
        key, jnp.asarray(vol), jnp.asarray(lbl), jnp.asarray(cands), patch)
    k = int(jax.random.randint(key, (), 0, len(cands)))
    ti, tl = taug.crop_at(torch.from_numpy(vol), torch.from_numpy(lbl),
                          torch.from_numpy(cands[k]), patch)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # a corner past the edge clamps, as lax.dynamic_slice clamps it
    ji = jax.lax.dynamic_slice(jnp.asarray(vol), (9, 9, 9, 0), patch + (2,))
    ti, _ = taug.crop_at(torch.from_numpy(vol), torch.from_numpy(lbl),
                         torch.from_numpy(cands[3]), patch)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_random_crop_draws_a_candidate(rng):
    vol = torch.from_numpy(rng.normal(size=(12, 11, 10, 1)).astype(
        np.float32))
    lbl = torch.zeros((12, 11, 10), dtype=torch.int32)
    cands = torch.tensor([[0, 0, 0], [3, 2, 1], [4, 5, 6]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    crops = [taug.random_crop_from_candidates(gen, vol, lbl, cands,
                                              (6, 5, 4))[0]
             for _ in range(12)]
    options = [taug.crop_at(vol, lbl, c, (6, 5, 4))[0] for c in cands]
    hits = {next(i for i, o in enumerate(options) if torch.equal(c, o))
            for c in crops}
    assert len(hits) > 1


def test_noise_mean_and_std():
    x = torch.zeros((2, 32, 32, 32, 1))
    y = taug.random_noise(torch.Generator().manual_seed(1), x, sigma=5.0)
    assert abs(y.mean().item()) < 0.05
    assert abs(y.std().item() - 5.0) < 0.05


def test_augment_batch_and_step_generator(rng):
    imgs = torch.from_numpy(rng.normal(size=(4, 6, 6, 6, 1)).astype(
        np.float32))
    lbls = torch.zeros((4, 6, 6, 6), dtype=torch.int32)
    a = taug.augment_batch(augment_generator(imgs.device, 7), imgs, lbls,
                           (0,), 2.0, (-1.0, 1.0))
    b = taug.augment_batch(augment_generator(imgs.device, 7), imgs, lbls,
                           (0,), 2.0, (-1.0, 1.0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # seed repeats
    c = taug.augment_batch(augment_generator(imgs.device, 8), imgs, lbls,
                           (0,), 2.0, (-1.0, 1.0))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == imgs.shape and a[1].dtype == torch.int32


def test_extract_device_augment_equals_jax_trainer():
    """On ``pipeline/pipeline_liver3D.yaml`` both trainers take
    ``RandomFlip`` and ``RandomNoise`` out of the host chain and keep the
    same ``(flip_axes, noise_sigma)``."""
    path = str(ROOT / "pipeline" / "pipeline_liver3D.yaml")
    out = []
    for cfg_mod, data_mod, cls in ((jconfig, jdata, JaxTrainer),
                                   (tconfig, tdata, Trainer)):
        chain = data_mod.build_pipeline(cfg_mod.load_pipeline(path),
                                        "train", 3)
        stub = types.SimpleNamespace(_train_step_fn=None, _device_aug=None)
        kept = cls._extract_device_augment(stub, chain)
        out.append(([type(t).__name__ for t in kept], stub._device_aug,
                     len(chain)))
    assert out[0] == out[1]
    names, aug, n = out[1]
    assert aug == ((0,), 5.0) and len(names) == n - 2
    assert "RandomFlip" not in names and "RandomNoise" not in names
