"""Reduction of a ``torch.profiler`` Chrome trace to per-layer readings.

Frozen copies of the port's ``profiler.GROUPS``, ``profiler.group_of`` and
``profiler.busy_union``, and of ``tools/analyze_trace.py``'s per-event
arithmetic (device events only: complete events of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; intervals measured from the
first start, since Kineto's epoch timestamps round each end). Busy time is
the union of the device events' intervals, so kernels that overlap on two
streams count once. The host's own work inside a span of the benchmark is
the span less the union of CUDA runtime and driver calls.
"""

from __future__ import annotations

import bisect
import collections
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")

GROUPS = (
    ("sendrecv", "halo exchange"), ("nccl", "collectives"),
    ("dw_mma_kernel", "dW kernel"), ("dw_partial_kernel", "dW kernel"),
    ("dw_reduce_kernel", "dW kernel"),
    ("dropout_kernel", "dropout kernel"),
    ("blend_accumulate_kernel", "blend kernel"),
    ("multi_tensor", "optimizer"), ("adam", "optimizer"),
    ("fprop", "cuDNN convolution"), ("dgrad", "cuDNN convolution"),
    ("wgrad", "cuDNN convolution"), ("conv", "cuDNN convolution"),
    ("implicit", "cuDNN convolution"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"), ("sm90", "matmul"),
    ("reduce", "reductions"), ("Memcpy", "copies"), ("Memset", "copies"),
)


def group_of(name: str) -> str:
    """The kernel group of a device event's name (``GROUPS``)."""
    low = name.lower()
    for fragment, group in GROUPS:
        if fragment.lower() in low:
            return group
    return "elementwise and other"


def busy_union(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: time that
    overlapping streams share counts once."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def outside(span: Tuple[float, float],
            busy: List[Tuple[float, float]]) -> float:
    """The part of ``span`` ``(start, end)`` that none of the disjoint
    sorted intervals ``busy`` covers."""
    s0, e0 = span
    i = bisect.bisect_right(busy, (s0, float("inf"))) - 1
    covered = 0.0
    for s, e in busy[max(i, 0):]:
        if s >= e0:
            break
        covered += max(0.0, min(e, e0) - max(s, s0))
    return (e0 - s0) - covered


@dataclass
class TraceReading:
    """What the per-layer readers read: the traced window and its work.

    ``window_s``: the window's length on the host clock. ``device``:
    ``(name, start_us, dur_us)`` of every device event, starts measured
    from the first device event. ``spans``: durations in ms of the
    benchmark's own ``record_function`` spans, by name; ``host_ms``: the
    same spans less the time the host spent inside CUDA runtime and driver
    calls (a launch that waits on a full queue, a blocking copy, a
    synchronise), so the host's own work; empty where the trace holds no
    runtime calls. ``steps``: the
    window's train steps or engine batches. ``work``: counts from the
    yardstick for the window's work (``flops``, ``dropout_bytes``,
    ``dropout_launches``, ``blend_bytes``, ``blend_launches``)."""

    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    host_ms: Dict[str, List[float]] = field(default_factory=dict)
    steps: int = 0
    work: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return busy_union((s, s + d) for _, s, d in self.device) / 1e6

    def group_ms(self, *groups: str) -> float:
        return sum(d for n, _, d in self.device
                   if group_of(n) in groups) / 1e3

    def name_ms(self, fragment: str) -> Tuple[float, int]:
        """Summed device ms and count of the events whose name holds
        ``fragment``."""
        ds = [d for n, _, d in self.device if fragment in n]
        return sum(ds) / 1e3, len(ds)

    def top_ops(self, n: int = 10) -> List[List]:
        ops = collections.defaultdict(float)
        for name, _, d in self.device:
            ops[name] += d / 1e6
        return [[k, v] for k, v in
                sorted(ops.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: str, window_s: float,
                      span_prefix: str = "portbench.") -> TraceReading:
    """A :class:`TraceReading` of a Chrome trace written by
    ``torch.profiler``'s ``export_chrome_trace``: its device events, the
    benchmark's spans (``record_function`` names that start with
    ``span_prefix``) and the idle gaps between device events, each named by
    the innermost host event that was open when the gap began."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host, runtime, marks = [], [], [], []
    spans = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        name = ev.get("name", "?")
        if cat in DEVICE_CATEGORIES:
            dev.append((name, ts, dur))
        elif cat in HOST_CATEGORIES:
            host.append((ts, dur, name))
            if cat == "user_annotation" and name.startswith(span_prefix):
                spans[name].append(dur / 1e3)
                marks.append((name, ts, dur))
        elif cat in RUNTIME_CATEGORIES:
            runtime.append((ts, dur))
    origin = min((ts for _, ts, _ in dev), default=0.0)
    device = [(n, ts - origin, d) for n, ts, d in dev]
    gaps = idle_gaps(device, [(ts - origin, d, n) for ts, d, n in host])
    waits = merged((ts - origin, ts - origin + d) for ts, d in runtime)
    host_ms = collections.defaultdict(list)
    for name, ts, d in (marks if waits else ()):
        host_ms[name].append(outside((ts - origin, ts - origin + d), waits)
                             / 1e3)
    return TraceReading(window_s=window_s, device=device, spans=dict(spans),
                        host_ms=dict(host_ms), gaps=gaps)


def idle_gaps(device, host, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle gaps summed by what the host was doing when each
    began (the innermost host event open then, or ``"host idle"``): the
    ``top`` largest, ``[name, seconds]``."""
    busy = merged((s, s + d) for _, s, d in device)
    host = sorted(host)  # (start, dur, name)
    by = collections.defaultdict(float)
    j, open_ = 0, []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        while j < len(host) and host[j][0] <= e0:
            open_.append(host[j])
            j += 1
        open_ = [h for h in open_ if h[0] + h[1] > e0]
        name = (min(open_, key=lambda h: h[1])[2] if open_
                else "host idle")
        by[name] += gap / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def quantile_p95(values) -> Optional[float]:
    """The 95th percentile, linear between closest ranks (numpy's default
    rule); ``None`` for no values."""
    vals = sorted(values)
    if not vals:
        return None
    pos = 0.95 * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
