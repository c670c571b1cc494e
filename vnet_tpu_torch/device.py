"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist — no silent CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return dev


def card_line():
    """``nvidia-smi``'s ``name, power.limit`` of the cards, one line a
    card, as every reading on the card is reported beside it; None where
    torch sees no CUDA device."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
