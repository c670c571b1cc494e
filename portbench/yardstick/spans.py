"""Device time put down to the program's own spans.

The port opens ``record_function`` spans named ``vnet.*`` at its phase
boundaries (``vnet_tpu_torch/profiler.py``). In a Chrome trace of
``torch.profiler`` every device event carries the CUDA correlation id of
the runtime or driver call that launched it (``args.correlation``), and
that call starts inside the host spans that were open while it ran. Each
device event goes to the innermost ``vnet.`` span, on any thread, that
holds the start of its launch: the shortest of those open then, since the
spans nest by time (a recompute on autograd's thread lies inside the
backward that the step's thread waits in). An event whose launch lies in
no ``vnet.`` span goes under ``""``; one whose launch the trace lacks is
unmatched (the profiler can lose events).

``attribute`` reduces a trace's events to a :class:`SpanReading`;
``READINGS`` holds the per-layer readings over one, each ``None`` where
its spans are absent, their count disagrees with the window's steps (train
steps, or engine batches), or the unmatched device time passes
``TRUSTED_UNMATCHED`` of the whole. The readings use the fields alone
(``program``, ``launched_ms``, ``unmatched_ms``, ``device``, ``steps``), so
they read any object that has them.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.yardstick.trace import (DEVICE_CATEGORIES, RUNTIME_CATEGORIES,
                                       merged, outside)

PREFIX = "vnet."
TRUSTED_UNMATCHED = 0.01

STEP = "vnet.train.step"
FORWARD = "vnet.train.forward"
BACKWARD = "vnet.train.backward"
RECOMPUTE = "vnet.remat.recompute"
VOLUME = "vnet.engine.volume"
ENGINE_FORWARD = "vnet.engine.forward"


@dataclass
class SpanReading:
    """``program``: the ``vnet.`` spans as ``(name, start_us, dur_us)``,
    starts from the first device event, as ``device`` (``(name, start_us,
    dur_us)`` of every device event); ``launched_ms``: device ms by the
    innermost span that launched it (``""``: none); ``unmatched_ms``:
    device ms whose launch the trace lacks; ``steps``: the window's train
    steps or engine batches."""

    program: List[Tuple[str, float, float]] = field(default_factory=list)
    launched_ms: Dict[str, float] = field(default_factory=dict)
    unmatched_ms: float = 0.0
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    steps: int = 0


def _count(r, name: str) -> int:
    return sum(1 for n, _, _ in r.program if n == name)


def _trusted(r) -> bool:
    device_ms = sum(d for _, _, d in r.device) / 1e3
    return device_ms > 0 and r.unmatched_ms <= TRUSTED_UNMATCHED * device_ms


def attribute(events: list, origin: Optional[float] = None) -> SpanReading:
    """A :class:`SpanReading` of a Chrome trace's ``traceEvents`` (steps
    left 0); ``origin``: where starts count from, by default the first
    device event's start."""
    dev, launch, program = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts = ev.get("cat"), float(ev["ts"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            dev.append((ev.get("name", "?"), ts, float(ev["dur"]), corr))
        elif cat in RUNTIME_CATEGORIES and corr is not None:
            launch[corr] = min(ts, launch.get(corr, ts))
        elif (cat == "user_annotation"
              and ev.get("name", "").startswith(PREFIX)):
            program.append((ev["name"], ts, float(ev["dur"])))
    if origin is None:
        origin = min((ts for _, ts, _, _ in dev), default=0.0)
    program.sort(key=lambda p: p[1])
    launched = collections.defaultdict(float)
    unmatched = 0.0
    timed = []  # (launch start, device dur)
    for _, _, dur, corr in dev:
        at = launch.get(corr) if corr is not None else None
        if at is None:
            unmatched += dur
        else:
            timed.append((at, dur))
    timed.sort()
    open_, j = [], 0  # spans started by the launch, pruned as they end
    for at, dur in timed:
        while j < len(program) and program[j][1] <= at:
            open_.append(program[j])
            j += 1
        open_ = [p for p in open_ if p[1] + p[2] >= at]
        name = min(open_, key=lambda p: p[2])[0] if open_ else ""
        launched[name] += dur
    return SpanReading(
        program=[(n, s - origin, d) for n, s, d in program],
        launched_ms={k: v / 1e3 for k, v in launched.items()},
        unmatched_ms=unmatched / 1e3,
        device=[(n, ts - origin, d) for n, ts, d, _ in dev])


def _per(r, name: str, count: str) -> Optional[float]:
    """``launched_ms[name]`` over the count of ``count`` spans, which must
    equal ``r.steps``."""
    n = _count(r, count)
    if not _trusted(r) or not n or n != r.steps:
        return None
    return r.launched_ms.get(name, 0.0) / n


def forward_ms_train(r) -> Optional[float]:
    return _per(r, FORWARD, FORWARD)


def backward_ms_train(r) -> Optional[float]:
    return _per(r, BACKWARD, BACKWARD)


def step_own_ms_train(r) -> Optional[float]:
    return _per(r, STEP, STEP)


def recompute_ms_train(r) -> Optional[float]:
    n = _count(r, RECOMPUTE)
    if not r.steps or not n or n % r.steps:
        return None
    return _per(r, RECOMPUTE, STEP)


def step_idle_ms_train(r) -> Optional[float]:
    """Device idle ms inside the ``vnet.train.step`` spans, a step."""
    steps = [(s, s + d) for n, s, d in r.program if n == STEP]
    if not _trusted(r) or not steps or len(steps) != r.steps:
        return None
    busy = merged((s, s + d) for _, s, d in r.device)
    return sum(outside(span, busy) for span in steps) / 1e3 / len(steps)


def engine_forward_ms_eval(r) -> Optional[float]:
    return _per(r, ENGINE_FORWARD, ENGINE_FORWARD)


def engine_own_ms_eval(r) -> Optional[float]:
    return _per(r, VOLUME, ENGINE_FORWARD)


READINGS = {
    "forward_ms.train": forward_ms_train,
    "backward_ms.train": backward_ms_train,
    "recompute_ms.train": recompute_ms_train,
    "step_own_ms.train": step_own_ms_train,
    "step_idle_ms.train": step_idle_ms_train,
    "engine_forward_ms.eval": engine_forward_ms_eval,
    "engine_own_ms.eval": engine_own_ms_eval,
}
