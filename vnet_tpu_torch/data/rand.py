"""Seedable RNG shared by the host-side stochastic transforms.

The reference uses the global ``np.random`` / ``random`` state
(e.g. reference `pipeline/NiftiDataset3D.py:200,518`); here every
transform draws from one module-level ``numpy.random.Generator`` that tests
and the trainer seed explicitly for reproducibility.
"""

from __future__ import annotations

import numpy as np

_rng = np.random.default_rng()


def get_rng() -> np.random.Generator:
    return _rng


def seed(value: int | None) -> None:
    global _rng
    _rng = np.random.default_rng(value)
