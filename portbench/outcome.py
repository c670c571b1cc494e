"""What a runner hands back to the harness after one run of a cell."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from portbench.yardstick.trace import TraceReading


@dataclass
class Outcome:
    """``metrics``: the end-to-end values by name (``--trace 0``);
    ``reading``: the traced window (``--trace 1``); ``numbers``: what the
    check compared, by name; ``attempted`` / ``failed``: the window's
    steps or volumes; ``memory_peak_bytes``: the card's peak over set-up
    and window; ``check_s``: the seconds the check took after the
    window."""

    metrics: Dict[str, float] = field(default_factory=dict)
    reading: Optional[TraceReading] = None
    numbers: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window_s: float = 0.0
    check_s: float = 0.0
