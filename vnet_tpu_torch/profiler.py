"""Step timing — counterpart of ``vnet_tpu/profiler.py``'s ``StepTimer``.

Host clock around each step; on the card the caller synchronises inside the
timed block (``Trainer`` reads the step's loss there), so a time is the
step's, not its enqueue's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


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
