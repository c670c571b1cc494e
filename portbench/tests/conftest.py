"""Fixtures of the benchmark's CPU tests: the cells at a tiny size (narrow
networks, small patches and volumes, float32), and the card check of the
tests marked ``cuda``.

    python -m pytest portbench/tests -q          # CPU, a few minutes
    python -m pytest portbench/tests -q -m cuda  # on a card
"""

from __future__ import annotations

import pytest
import torch

from portbench import spec

TRAIN = "vnet3d_liver.train_256x256x32_b32_remat"
EVAL = "vnet3d_liver.eval_512xD_gauss"
ATTENTION = "attention3d_mm.train_64_b16"


def tiny(name: str, patch, batch: int, precision: str = "float32",
         **traffic) -> spec.Cell:
    """A cell of the repository at a size the CPU runs in seconds: 4
    channels, 2 levels, dropout 0.1, the given patch and batch, an
    evaluation stride of half the patch and batches of 3."""
    cell = spec.load_cell(name)
    tree = cell.config["settings"]
    net = tree["TrainingSetting"]["Networks"]
    net.update(NumChannel=4, NumLevels=2, NumConvolutions=[1, 2],
               BottomConvolutions=1, Dropout=0.1)
    tree["TrainingSetting"].update(PatchShape=list(patch), BatchSize=batch,
                                   Precision=precision)
    tree["EvaluationSetting"].update(Stride=[p // 2 for p in patch],
                                     BatchSize=3)
    cell.workload["traffic"].update(traffic)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def tiny_train():
    return tiny(TRAIN, [16, 16, 8], 2)


@pytest.fixture
def tiny_attention():
    return tiny(ATTENTION, [16, 16, 16], 2)


@pytest.fixture
def tiny_eval():
    return tiny(EVAL, [16, 16, 8], 2, xy=[24, 24], depths=[8, 16, 24])


@pytest.fixture
def card():
    """Skips a test marked ``cuda`` where torch sees no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
