"""``SwinUNETR``'s data-parallel training step on the CPU: two ``gloo``
ranks (``parallel.launch``, a ``file://`` rendezvous; the rank function
``torch_parallel_ranks.swin_step``, which imports no JAX) of one row each
against one process on both rows, at ``test_torch_swin_unetr.py``'s small
size.
SwinUNETR has no batch statistics, so the step is the trainer's gradient
average alone.

Tolerances: the loss to a relative ``1e-5``; each leaf's averaged gradient
within ``DP_GRAD_RTOL = 1e-3`` of its largest entry (float32 sums over
the voxels in two halves; the worst leaf, measured 2.3e-4, is
``encoder1``'s 1^3 residual convolution from the one input channel, whose
gradient through the instance norm behind it cancels to a few digits);
the ranks' parameters after the step bitwise equal.
"""

import numpy as np
import pytest
import torch

import test_torch_swin_unetr as swin
from torch_parallel_ranks import swin_step, trainer_step
from fixtures import make_dataset_dir
from portbench.reference import swin_unetr_btcv as ref
from portbench.yardstick import data
from vnet_tpu_torch.parallel import launch

DP_GRAD_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs in several workers at once,
    and these 3D convolutions on every core of each worker thrash."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_data_parallel_step_matches_one_process(tmp_path):
    """Two ranks of one row each against one process on both rows (the
    module's tolerances)."""
    make_dataset_dir(str(tmp_path), "training", num_cases=1,
                     rng=np.random.default_rng(1), shape=(32, 32, 32))
    cfg = swin._write_config(tmp_path)
    weights = data.make_weights(ref.named_shapes(
        {"in_channels": 1, "num_channel": swin.FEATURE, "num_classes": 2}), 3,
        "cpu")
    batch = data.train_batch(3, 0, 2, swin.PATCH, 1, 2, False, "cpu")
    torch.save({"config": cfg, "state_dict": weights,
                "images": batch["images"], "labels": batch["labels"]},
               tmp_path / "inputs.pt")
    launch(swin_step, 2, backend="gloo", device="cpu",
           init_method=f"file://{tmp_path / 'rendezvous'}",
           args=(str(tmp_path),), timeout=240.0)
    one = trainer_step(cfg, weights, batch["images"], batch["labels"], 0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert abs(ranks[0]["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    gaps = {k: float((ranks[0]["grads"][k] - g).abs().max())
            / max(float(g.abs().max()), 1e-30)
            for k, g in one["grads"].items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= DP_GRAD_RTOL, (worst, gaps[worst])
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k
