"""Tracing and step timing — counterpart of ``vnet_tpu/profiler.py``.

``TraceCapture`` records a ``torch.profiler`` trace (host operators, and
the card's kernels and copies when the device is CUDA) and writes it as a
Chrome trace JSON into its directory (viewable in Perfetto or
``chrome://tracing``), as ``jax.profiler`` traces a phase of the JAX CLI;
or, over a window of training steps, the device's idle share.

``StepTimer``: host clock around each step; on the card the caller
synchronises inside the timed block (``Trainer`` reads the step's loss
there), so a time is the step's, not its enqueue's.

``span(name)``: a ``record_function`` span at one of the port's phase
boundaries, so that a trace of the card puts each kernel under the phase
whose host code launched it (the launch and the kernel share a CUDA
correlation id). With no profiler running it is a null context, one flag
check. The spans, and the reading of the benchmark's span attribution
(``portbench/yardstick/spans.py``: device ms of the kernels each span
launched, less those of the spans inside it) that reads each:

* ``vnet.train.step``, ``Trainer.train_step``: the batch's host-to-device
  copies, the device augmentation, the learning rate, the optimizer and
  the logged metrics (``step_own_ms.train``; the device's idle time inside
  it, ``step_idle_ms.train``);
* ``vnet.train.forward``, the train step's network forward and its loss
  terms (``forward_ms.train``);
* ``vnet.train.backward``, the train step's ``loss.backward()``, whose
  kernels autograd's device thread launches while the step's thread waits
  in the span (``backward_ms.train``);
* ``vnet.remat.recompute``, one ``Remat`` block's recompute in the
  backward pass, on autograd's thread (``recompute_ms.train``);
* ``vnet.engine.volume``, ``SlidingWindowInference.__call__``: the
  volume's upload, the accumulator, each batch's gather, window weighting,
  flags and blend (``engine_own_ms.eval``);
* ``vnet.engine.forward``, one engine batch's network forward and softmax
  (``engine_forward_ms.eval``).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


class TraceCapture:
    """``start()`` / ``stop()`` or a ``with`` block around the work to
    trace; ``stop()`` writes ``trace_<secs>_<pid>.json`` into ``log_dir``
    and keeps its path in ``path``.

    ``steps=(start, count)`` traces a window of a loop that calls ``step()``
    after each of its steps (``Trainer(trace=...)`` does): the card's
    kernels alone (no host operators, so the host-bound steps it watches
    stretch less) over steps ``start + 1`` to ``start + count`` and all
    between them, the loader's waits included, behind one step of profiler
    warm-up. ``step()`` also stamps the host clock, so ``reading`` (None on
    the CPU, or until the window closed) holds, in ms: the window's
    ``span_ms`` on the host clock, the device's ``busy_ms`` in it and its
    ``idle`` share; its ``step_ms`` (span / count) beside the
    ``unprofiled_step_ms`` (the median step of the loop outside the window,
    the first two steps, the warm-up and the step after the window left
    out), whose difference is the profiler's own cost; and
    ``idle_unprofiled``, the share of the unprofiled step that the window's
    device time a step leaves idle. ``log_dir`` None writes no file."""

    def __init__(self, log_dir: Optional[str], device="cpu",
                 steps: Optional[Tuple[int, int]] = None):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self.steps = steps
        self.path: Optional[str] = None
        self._prof = None
        self._stamps: List[float] = []
        self._window: Optional[Tuple[float, float]] = None
        self._open = 0.0

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if self.steps is None:
            self._prof = torch.profiler.profile(activities=acts)
        else:
            self._stamps, self._window = [time.perf_counter()], None
            if self.device.type != "cuda":
                return
            first, count = self.steps
            self._prof = torch.profiler.profile(
                activities=acts[1:], on_trace_ready=self._window_done,
                schedule=torch.profiler.schedule(
                    wait=max(0, first - 1), warmup=min(1, first),
                    active=count, repeat=1))
        self._prof.start()
        if self.steps is not None and self.steps[0] == 0:
            self._open = time.perf_counter()  # recording from the start

    def step(self):
        """The end of one step of the loop a window watches."""
        if self.steps is None:
            return
        self._stamps.append(time.perf_counter())
        if self._prof is not None:
            self._prof.step()
            if len(self._stamps) == self.steps[0] + 1:  # it opened here
                self._open = time.perf_counter()

    def _window_done(self, prof):
        first, count = self.steps
        if len(self._stamps) <= first + count:
            return  # the loop ended inside the window: no reading
        _, busy = device_busy(prof)
        span = 1e3 * (self._stamps[first + count] - self._open)
        self._window = (span, busy)
        self._export(prof)

    @property
    def reading(self) -> Optional[dict]:
        if self._window is None or self._window[1] <= 0:
            return None
        span, busy = self._window
        first, count = self.steps
        skip = range(first, first + count + 2)  # warm-up .. step after
        outside = [1e3 * (b - a) for i, (a, b) in enumerate(
            zip(self._stamps, self._stamps[1:]), 1)
            if i > 2 and i not in skip]
        out = {"steps": count, "first_step": first + 1, "span_ms": span,
               "busy_ms": busy, "idle": 1 - busy / span,
               "step_ms": span / count, "unprofiled_step_ms": None,
               "idle_unprofiled": None}
        if outside:
            step = statistics.median(outside)
            out.update(unprofiled_step_ms=step,
                       idle_unprofiled=1 - busy / count / step)
        return out

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        if self.steps is None:
            self._export(prof)

    def _export(self, prof):
        if self.log_dir is None:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{int(time.time())}_{os.getpid()}.json")
        prof.export_chrome_trace(self.path)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler records,
    else a null context (module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


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

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else float("nan")


# kernel-name fragments -> group, first match wins: cuDNN's convolution
# kernels name their pass (fprop, dgrad, wgrad) or "conv"; the other GEMM
# kernels are the matrix products (the packed network's down and up
# convolutions, its 1^r output conv, and the packed kernels' dx)
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


def device_busy(prof) -> Tuple[float, float]:
    """``(span_ms, busy_ms)`` of a ``torch.profiler`` run: the span from its
    first host event to its last device event, and the union of its device
    events' intervals (the device's idle share is ``1 - busy / span``)."""
    device, host_start = [], float("inf")
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((start, end))
        else:
            host_start = min(host_start, start)
    if not device:
        return float("nan"), 0.0
    span = (max(e for _, e in device)
            - min(host_start, min(s for s, _ in device)))
    return span / 1e3, busy_union(device) / 1e3
