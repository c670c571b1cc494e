"""Weights-only checkpoints of the port: a ``state_dict`` per step.

Counterpart of ``vnet_tpu/train/checkpoints.py`` for what evaluation needs:
``save`` writes ``<directory>/weights_<step>.pt`` with ``torch.save`` and
``restore_latest`` reads the newest one. Reading the JAX package's orbax
checkpoints (through ``convert.py``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

_NAME = re.compile(r"^weights_(\d+)\.pt$")


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _NAME.match(f))]
    return max(steps) if steps else None


def save(directory: str, state_dict: Dict[str, torch.Tensor],
         step: int) -> str:
    """Write ``state_dict`` (moved to the CPU) as step ``step``; returns
    the file path. The file is written under a temporary name and renamed,
    so a reader never sees a partial checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"weights_{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def restore_latest(directory: str) -> Optional[Dict[str, torch.Tensor]]:
    """The newest ``state_dict`` under ``directory`` (CPU tensors), or None
    when there is none."""
    step = latest_step(directory)
    if step is None:
        return None
    return torch.load(os.path.join(directory, f"weights_{step}.pt"),
                      map_location="cpu", weights_only=True)
