"""Tracing and step timing — counterpart of ``vnet_tpu/profiler.py``.

``TraceCapture`` records a ``torch.profiler`` trace (host operators, and
the card's kernels and copies when the device is CUDA) and writes it as a
Chrome trace JSON into its directory (viewable in Perfetto or
``chrome://tracing``), as ``jax.profiler`` traces a phase of the JAX CLI.

``StepTimer``: host clock around each step; on the card the caller
synchronises inside the timed block (``Trainer`` reads the step's loss
there), so a time is the step's, not its enqueue's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


class TraceCapture:
    """``start()`` / ``stop()`` or a ``with`` block around the work to
    trace; ``stop()`` writes ``trace_<secs>_<pid>.json`` into ``log_dir``
    and keeps its path in ``path``."""

    def __init__(self, log_dir: str, device="cpu"):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.path: Optional[str] = None
        self._prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{int(time.time())}_{os.getpid()}.json")
        prof.export_chrome_trace(self.path)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


@dataclass
class StepTimer:
    """Online step timing: ``with timer:`` around each step; the first
    ``warmup`` steps are not recorded."""

    warmup: int = 2
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None
    _count: int = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else float("nan")
