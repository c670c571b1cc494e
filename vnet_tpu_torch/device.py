"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist — no silent CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return dev
