"""Checkpoints of the port's training state.

Counterpart of ``vnet_tpu/train/checkpoints.py``: one file per global step,
``<directory>/ckpt_<step>.pt``, holding the whole train state — the model
``state_dict`` (parameters and batch-norm running averages), the
optimizer's ``state_dict``, ``step`` and ``epoch`` — so that a resumed run
continues the step and epoch counts. The newest checkpoint is the one with
the highest step, as orbax's ``CheckpointManager.latest_step`` finds it;
only the ``max_to_keep`` newest files are kept. ``restore_latest`` returns
the model weights alone, which is what evaluation needs. In a data-parallel
run only rank 0 writes (the trainer calls :func:`save` there alone), and
every rank restores the step rank 0 found (:func:`restore_state`).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _NAME.match(f)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save(directory: str, state_dict: Dict[str, torch.Tensor], step: int,
         optimizer_state: Optional[dict] = None, epoch: int = 0,
         max_to_keep: int = 5) -> str:
    """Write the train state of ``step`` (tensors moved to the CPU) and
    return the file path. The file is written under a temporary name and
    renamed, so a reader never sees a partial checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{int(step)}.pt")
    tmp = path + ".tmp"
    torch.save({
        "model": {k: v.detach().cpu() for k, v in state_dict.items()},
        "optimizer": _to_cpu(optimizer_state),
        "step": int(step), "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"ckpt_{old}.pt"))
    return path


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def restore_state(directory: str, step: int) -> dict:
    """The checkpoint of ``step`` under ``directory`` as ``{"model",
    "optimizer", "step", "epoch"}`` (CPU tensors). Data-parallel ranks
    restore the step rank 0 found, so they resume from the same one."""
    return torch.load(os.path.join(directory, f"ckpt_{int(step)}.pt"),
                      map_location="cpu", weights_only=True)


def restore_latest_state(directory: str) -> Optional[dict]:
    """The newest checkpoint under ``directory`` (:func:`restore_state`),
    or None."""
    step = latest_step(directory)
    return None if step is None else restore_state(directory, step)


def restore_latest(directory: str) -> Optional[Dict[str, torch.Tensor]]:
    """The newest checkpoint's model ``state_dict``, or None."""
    state = restore_latest_state(directory)
    return None if state is None else state["model"]
