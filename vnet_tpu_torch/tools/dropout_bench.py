"""The dropout kernel at every dropout shape of the three main-path training
steps, timed on the card.

    python -m vnet_tpu_torch.tools.dropout_bench [--out FILE.json]
        [--compare SRC ...] [--steps] [--space S] [--list]

The shapes come from the module trees: a forward pre-hook on every
``Dropout`` of the network that the step's config builds (packed, as the
trainer builds it: the packed levels' dropout inputs hold 128 channels), run once in eval
mode on the ``meta`` device (no memory, no arithmetic) at the step's patch;
the batch is the step's. A training step launches the kernel twice per
layer, forward and backward (the backward regenerates the mask):

* ``flagship``: ``configs/config.json``'s network at ``bench.py``'s patch
  64^3 and batch 96, flavours ``pallas`` (``chip_smoke.py`` phase 7),
  ``bits8`` (``configs/bench_tuning.json``) and ``xla`` (the configs'
  default): 5 shapes, 21 layers;
* ``attention``: ``configs/config_attention_multimodal.json`` at its width,
  patch 64^3 and batch 8, ``xla``: 6 shapes, 33 layers;
* ``2d``: ``configs/config_2d.json`` at its patch 256^2 and batch 32,
  ``xla``: 5 shapes, 21 layers.

For each distinct shape (bf16, channels-last, random data from a seed) and
flavour: the kernel's device ms per launch, the median over a
``torch.profiler`` trace of ``LAUNCHES`` launches (after an untimed trace;
records too short to be right are dropped, and a trace that
:func:`span_median` refuses is taken again, see :func:`device_ms`);
the CUDA-event ms per launch around ``LAUNCHES`` launches, all queued
behind a spin before the first event, that rotate over enough input
buffers to fill twice the 50 MB L2 cache, so that no launch reads its
input from L2, which must agree with the device ms where the input fills
the L2 (:func:`check_events`); the CUDA-event ms
around a single
wrapper call (median of 25; host time included, as the readings before
this tool were taken); the wrapper's host microseconds per call
(``dropout_apply``, host clock around 20 calls, median of 5 runs);
``F.dropout``'s device and event ms, taken the same way; and the byte bound
(x read once, the output written once, at 3.35 TB/s). Then, per step and
flavour, the sum over shapes of launches per step x device ms beside the
sum of the bounds.

``--compare SRC``: another whole copy of the kernel with the same C
interface (an earlier ``dropout.cu``, or another design, kept outside the
package), built with the package's flags and timed beside the package's
kernel at every shape in the same process; its output is held bitwise
against the package's. ``--steps`` profiles one
step of each of the three (after warm-up steps): the dropout kernels'
launches and device ms in the step (each launch's in the output file), and
the copies (``aten::copy_``) made
inside dropout's forward and backward, which would be layout copies of
their inputs. ``--space S`` also times the flagship step's shapes as a
rank of a ``SpaceParallel`` S grid launches them: the slab of the first
spatial axis (``(B, C, X/S, Y, Z)``) under its row map (``L = X/S*Y*Z*C``,
``G = X*Y*Z*C``, the base of slab 1), each held bitwise against the plain
version at the first launch. ``--list`` prints the shapes and exits; it
needs no card.
The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import time
from collections import Counter
from pathlib import Path

import torch

from ..config import load_config
from ..device import card_line
from ..models import build_network
from ..models.layers import Dropout

ROOT = Path(__file__).resolve().parents[2]
STEPS = {  # name: (config, patch, batch, flavours)
    "flagship": (ROOT / "configs" / "config.json", (64, 64, 64), 96,
                 ("pallas", "bits8", "xla")),
    "attention": (ROOT / "configs" / "config_attention_multimodal.json",
                  None, 8, ("xla",)),
    "2d": (ROOT / "configs" / "config_2d.json", None, 32, ("xla",)),
}
RATE = 0.01  # every shipped config's Dropout
LAUNCHES = 50
L2_BYTES = 50e6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet
# Where the input is at least CHECK_BYTES, the event time per launch must be
# within EVENT_MARGIN of the device time. Below it, the event time held the
# host's enqueue (2x the device time at 17 MB on the H100); at or above it
# the two differed by at most 8.2% on the H100 (PERF.md).
CHECK_BYTES = 64e6
EVENT_MARGIN = 0.15
# event_ms first holds the card in a spin of this many clock cycles (about
# 50 ms at the H100's 1.98 GHz) while the host queues every timed launch, so
# a host slowed by other processes cannot stretch the event time.
QUEUE_CYCLES = 100_000_000
# Traces device_ms takes before it gives up: a busy host has made the
# tracer lose records or cut spans short (on the H100 machine, 38 records
# for 50 launches, all under the floor).
TRACE_TRIES = 4


def step_network(step: str, device="meta"):
    """``(network, patch, batch, input channels)`` of a step: its config's
    network in bf16, built as the trainer builds it, with the step's patch
    and batch."""
    path, patch, batch, _ = STEPS[step]
    t = load_config(str(path)).train
    n = t.network
    net = build_network(
        "AttentionVNet" if n.attention else n.name,
        num_classes=t.num_classes, in_channels=t.input_channels,
        dropout_rate=n.dropout, num_channels=n.num_channel,
        num_levels=n.num_levels, num_convolutions=n.num_convolutions,
        bottom_convolutions=n.bottom_convolutions, norm=n.norm,
        packed_target_lanes=n.packed_target_lanes, dtype=torch.bfloat16,
        device=device, spatial_rank=t.dimension)
    return net, tuple(patch or t.patch_shape), batch, t.input_channels


def dropout_shapes(step: str, patch=None, batch=None):
    """``[(shape, layers)]``: the distinct input shapes of the step's
    ``Dropout`` layers in the order the forward first meets them, each
    with its number of layers, at the step's patch and batch unless given.
    One eval-mode forward on the ``meta`` device."""
    net, step_patch, step_batch, channels = step_network(step)
    patch = tuple(patch or step_patch)
    batch = batch or step_batch
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
        for m in net.modules() if isinstance(m, Dropout)]
    net.eval()
    with torch.no_grad():
        net(torch.zeros((1,) + patch + (channels,), device="meta"))
    for h in hooks:
        h.remove()
    counts = Counter((batch,) + s[1:] for s in seen)
    return list(counts.items())


def bound_ms(shape, element_size: int = 2) -> float:
    """Read x once, write the output once."""
    return 2 * math.prod(shape) * element_size / HBM_BYTES_PER_S * 1e3


def floor_ms(shape, element_size: int = 2) -> float:
    """The least time a launch can take when its input comes from HBM: x
    read once, and as much of the output written back as the L2 cannot
    hold when the kernel ends. A span shorter than this cannot be right."""
    nbytes = math.prod(shape) * element_size
    return (nbytes + max(0.0, nbytes - L2_BYTES)) / HBM_BYTES_PER_S * 1e3


def _inputs(shape, gen):
    """Channels-last bf16 inputs that together fill twice the L2 cache."""
    nbytes = math.prod(shape) * 2
    fmt = (torch.channels_last_3d if len(shape) == 5
           else torch.channels_last)
    return [(torch.randn(shape, generator=gen, device="cuda") * 30.0).to(
        torch.bfloat16).contiguous(memory_format=fmt)
        for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def span_median(spans, count: int, floor: float):
    """``(median ms, dropped)`` of one trace's kernel spans (ms) of
    ``count`` calls. The tracer drops some records and truncates some
    spans: spans under ``floor`` (:func:`floor_ms`) cannot be right and are
    dropped. More spans than calls, or fewer than half of them left,
    raise."""
    kept = [t for t in spans if t >= floor]
    if len(spans) > count or len(kept) < count / 2:
        raise SystemExit(f"dropout_bench: {len(spans)} device events for "
                         f"{count} calls, {len(kept)} of them at least the "
                         f"{floor:.4f} ms floor")
    return statistics.median(kept), len(spans) - len(kept)


def device_ms(call, count: int, floor: float):
    """``(ms, kernel names, dropped, retakes)``: :func:`span_median` of the
    one kernel each of ``count`` calls ``call(i)`` launches, from a
    ``torch.profiler`` trace taken after an untimed one (a cold trace can
    drop kernel records). A trace that :func:`span_median` refuses is
    taken again (``retakes``), up to ``TRACE_TRIES`` in all; the last
    refusal raises."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for i in range(2):
            call(i)
        torch.cuda.synchronize()
    for retakes in range(TRACE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(count):
                call(i)
            torch.cuda.synchronize()
        spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        try:
            ms, dropped = span_median([t for _, t in spans], count, floor)
        except SystemExit as e:
            print(f"trace {retakes + 1} of {TRACE_TRIES} refused: {e}",
                  flush=True)
            if retakes == TRACE_TRIES - 1:
                raise
            continue
        return ms, sorted({name for name, _ in spans}), dropped, retakes


def check_events(what: str, shape, device: float, event: float,
                 element_size: int = 2) -> None:
    """Fail where the input is at least ``CHECK_BYTES`` and the event ms
    per launch is not within ``EVENT_MARGIN`` of the device ms."""
    if (math.prod(shape) * element_size >= CHECK_BYTES
            and abs(event - device) > EVENT_MARGIN * device):
        raise SystemExit(f"dropout_bench: {what} at {tuple(shape)}: device "
                         f"{device:.4f} ms against events {event:.4f} ms, "
                         f"more than {EVENT_MARGIN:.0%} apart")


def event_ms(call, count: int, queue_cycles: int = QUEUE_CYCLES) -> float:
    """CUDA-event ms per call around ``count`` calls, after one warm-up
    pass, with every call queued behind a spin of ``queue_cycles`` before
    the first event: the card's back-to-back time (0: no spin, so the host's
    enqueue rate shows, as ``tools/event_check.py`` compares)."""
    for i in range(count):
        call(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_cycles:
        torch.cuda._sleep(queue_cycles)
    start.record()
    for i in range(count):
        call(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def call_ms(call, reps: int = 25) -> float:
    """Median CUDA-event ms around one call, host time included: how the
    readings before this tool were taken, kept for comparison."""
    times = []
    for i in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def host_us(call, calls: int = 20, runs: int = 5) -> float:
    """Median host microseconds per call over ``runs`` runs of ``calls``
    calls, each run ending in a synchronise outside the clock."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            call(i)
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def kernel_registers(log: str):
    """``[(instantiation, registers)]`` from nvcc's ``-Xptxas -v`` log
    (empty when this process did not compile the library): each
    ``dropout_kernel<T, DIV, ROWS>`` as ``"bf16 divide"`` (``"bf16 divide
    rows"`` with the row walk) and the like, with its registers a thread,
    which set the blocks that fit on an SM."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*dropout_kernelI"
                      r"(f|13__nv_bfloat16|6__half)Lb([01])E(?:Lb([01])E)?",
                      line)
        if m:
            entry = (types[m.group(1)] + " "
                     + ("divide" if m.group(2) == "1" else "multiply")
                     + (" rows" if m.group(3) == "1" else ""))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1))))
            entry = None
    return out


def slab_map(shape, space: int):
    """``(slab shape, (base, L, G))`` of space rank 1's slab of the first
    spatial axis of the logical ``(B, C, X, ...)`` ``shape`` under a
    ``SpaceParallel`` of ``space``."""
    slab = tuple(shape[:2]) + (shape[2] // space,) + tuple(shape[3:])
    row_len = math.prod(slab[1:])
    return slab, (row_len, row_len, math.prod(shape[1:]))


def measure_shape(shape, impls, gen, compare=(), row_map=(0, 0, 0)):
    """One row per flavour at ``shape``: see the module docstring;
    ``row_map`` = ``(base, row_len, row_stride)`` of every launch."""
    import torch.nn.functional as F

    from ..ops.dropout import dropout_apply, dropout_params, dropout_plain

    xs = _inputs(shape, gen)
    count = max(LAUNCHES, len(xs))
    floor = floor_ms(shape)
    rows = []
    for impl in impls:
        params = dropout_params(RATE, impl)

        def kernel(i):
            return dropout_apply(xs[i % len(xs)], 1234, 5, *params,
                                 *row_map)

        if any(row_map) and not torch.equal(
                kernel(0), dropout_plain(xs[0], 1234, 5, *params, *row_map)):
            raise SystemExit(f"dropout_bench: the kernel differs from the "
                             f"plain version at {shape} {impl} {row_map}")
        ms, names, dropped, retakes = device_ms(kernel, count, floor)
        if not all("dropout_kernel" in n for n in names):
            raise SystemExit(f"dropout_bench: other kernels {names}")
        row = dict(shape=list(shape), impl=impl, row_map=list(row_map),
                   device_ms=ms,
                   dropped=dropped, retakes=retakes,
                   event_ms=event_ms(kernel, count),
                   call_ms=call_ms(kernel), host_us=host_us(kernel),
                   bound_ms=bound_ms(shape))
        check_events(impl, shape, ms, row["event_ms"])
        for name, fn in compare:
            from ..ops.dropout import launch_with

            def other(i, fn=fn):
                return launch_with(fn, xs[i % len(xs)], 1234, 5, *params,
                                   *row_map)

            equal = all(torch.equal(other(i), kernel(i))
                        for i in range(min(2, len(xs))))
            if not equal:
                raise SystemExit(f"dropout_bench: {name} differs from the "
                                 f"package's kernel at {shape} {impl}")
            c_ms, c_names, c_dropped, c_retakes = device_ms(other, count,
                                                            floor)
            row[name] = dict(device_ms=c_ms, kernels=c_names,
                             dropped=c_dropped, retakes=c_retakes,
                             event_ms=event_ms(other, count),
                             host_us=host_us(other), bitwise_equal=equal)
            check_events(f"{name} {impl}", shape, c_ms,
                         row[name]["event_ms"])
        rows.append(row)

    def library(i):
        return F.dropout(xs[i % len(xs)], RATE, training=True)

    # F.dropout also writes a one-byte mask: its floor is higher still
    lib_ms, lib_names, lib_dropped, lib_retakes = device_ms(library, count,
                                                            floor)
    lib = dict(device_ms=lib_ms, kernels=lib_names, dropped=lib_dropped,
               retakes=lib_retakes, event_ms=event_ms(library, count))
    check_events("F.dropout", shape, lib_ms, lib["event_ms"])
    for row in rows:
        row["F.dropout"] = lib
    del xs
    torch.cuda.empty_cache()
    return rows


def layout_copies(events) -> dict:
    """``{"forward": n, "backward": n}``: the ``aten::copy_`` calls made by
    an ``aten::contiguous`` or ``aten::clone`` inside dropout's forward
    (``_Dropout``) or backward (``_DropoutBackward``) in a profiler's
    events: copies of an input into the kernel's storage order."""
    copies = {"forward": 0, "backward": 0}
    for e in events:
        if e.name != "aten::copy_":
            continue
        layout, parent = False, e.cpu_parent
        while parent is not None:
            layout |= parent.name in ("aten::contiguous", "aten::clone")
            if parent.name in ("_Dropout", "_DropoutBackward"):
                copies["backward" if "Backward" in parent.name
                       else "forward"] += layout
                break
            parent = parent.cpu_parent
    return copies


def profile_steps():
    """One profiled step of each main path: dropout kernels, their device
    ms, and the ``aten::copy_`` calls inside dropout's forward and
    backward (layout copies of their input)."""
    from . import profile_step as ps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for step, build, impl, batch in (
            ("flagship", ps.flagship_step, "pallas", 96),
            ("attention", ps.attention_step, "xla", 8),
            ("2d", ps.config2d_step, "xla", 32)):
        state, fn, images, labels = build(impl, batch)
        ps.timed_steps(state, fn, images, labels, 3)
        with torch.profiler.profile(activities=acts) as prof:
            fn(state, images, labels, dropout_seed=state.step)
            torch.cuda.synchronize()
        kernels = [(e.time_range.end - e.time_range.start) / 1e3
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "dropout_kernel" in e.name]
        copies = layout_copies(prof.events())
        out[step] = dict(impl=impl, batch=batch, launches=len(kernels),
                         device_ms=sum(kernels), copies=copies,
                         launch_ms=kernels)
        print(f"{step} step ({impl}, batch {batch}): {len(kernels)} dropout "
              f"kernels, {sum(kernels):.4f} ms of device time; aten::copy_ "
              f"inside dropout: forward {copies['forward']}, backward "
              f"{copies['backward']}", flush=True)
        del state, fn, images, labels, prof
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "dropout_bench")
    parser.add_argument("--out", help="also write every reading as JSON")
    parser.add_argument("--compare", nargs="*", default=[], metavar="SRC",
                        help="whole copies of the dropout kernel with the "
                             "same C interface (.cu paths), timed beside "
                             "the package's")
    parser.add_argument("--steps", action="store_true",
                        help="also profile one step of each main path")
    parser.add_argument("--space", type=int, default=0, metavar="S",
                        help="also time the flagship's shapes as slabs of "
                             "a SpaceParallel S grid, row-mapped")
    parser.add_argument("--list", action="store_true",
                        help="print the shapes and exit (no card needed)")
    args = parser.parse_args(argv)
    shapes = {step: dropout_shapes(step) for step in STEPS}
    for step, rows in shapes.items():
        layers = sum(n for _, n in rows)
        print(f"{step}: {len(rows)} shapes, {layers} layers, {2 * layers} "
              f"launches a step: "
              + ", ".join(f"{s} x{n}" for s, n in rows), flush=True)
    if args.list:
        return
    if not torch.cuda.is_available():
        raise SystemExit("dropout_bench needs a CUDA card")
    from ..ops import build
    from ..ops.dropout import bind

    smi = card_line()
    print(f"card: {smi}", flush=True)
    for kernel, regs in kernel_registers(build.load("dropout").log):
        print(f"dropout.cu ptxas: {kernel} {regs} registers", flush=True)
    compare = []
    for spec in args.compare:
        built = build.load_source(Path(spec))
        for kernel, regs in kernel_registers(built.log):
            print(f"{spec} ptxas: {kernel} {regs} registers", flush=True)
        compare.append((spec, bind(built.lib)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}  # (shape, impl) -> row; shapes shared by steps run once
    for step, rows in shapes.items():
        impls = STEPS[step][3]
        for shape, _ in rows:
            todo = [i for i in impls if (shape, i) not in table]
            for row in measure_shape(shape, todo, gen, compare):
                table[(shape, row["impl"])] = row
                print(_row_line(row, [n for n, _ in compare]), flush=True)
    impls = {step: spec[3] for step, spec in STEPS.items()}
    if args.space:
        step = f"flagship slab {args.space}"
        impls[step] = STEPS["flagship"][3]
        shapes[step] = []
        for shape, n in shapes["flagship"]:
            slab, row_map = slab_map(shape, args.space)
            shapes[step].append((slab, n))
            for row in measure_shape(slab, impls[step], gen, compare,
                                     row_map):
                table[(slab, row["impl"])] = row
                print(_row_line(row, [n for n, _ in compare]), flush=True)
    sums = {}
    for step, rows in shapes.items():
        for impl in impls[step]:
            per = [(2 * n, table[(s, impl)]) for s, n in rows]
            entry = dict(
                launches=sum(k for k, _ in per),
                device_ms=sum(k * r["device_ms"] for k, r in per),
                event_ms=sum(k * r["event_ms"] for k, r in per),
                bound_ms=sum(k * r["bound_ms"] for k, r in per),
                library_device_ms=sum(k * r["F.dropout"]["device_ms"]
                                      for k, r in per))
            for name, _ in compare:
                entry[name] = sum(k * r[name]["device_ms"] for k, r in per)
            sums[f"{step} {impl}"] = entry
            print(f"{step} step, {impl}: {entry['launches']} launches, "
                  f"device {entry['device_ms']:.4f} ms (events "
                  f"{entry['event_ms']:.4f}) against a bound of "
                  f"{entry['bound_ms']:.4f} ms, "
                  f"{entry['bound_ms'] / entry['device_ms']:.1%}; F.dropout "
                  f"{entry['library_device_ms']:.4f} ms"
                  + "".join(f"; {n} {entry[n]:.4f} ms" for n, _ in compare),
                  flush=True)
    steps = profile_steps() if args.steps else None
    if not args.out:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, rate=RATE, launches=LAUNCHES,
                       shapes={k: [[list(s), n] for s, n in v]
                               for k, v in shapes.items()},
                       rows=list(table.values()), sums=sums, steps=steps),
                  f, indent=1)


def _row_line(row, compare) -> str:
    lib = row["F.dropout"]
    share = row["bound_ms"] / row["device_ms"]
    line = (f"{tuple(row['shape'])} {row['impl']:6s}"
            + (f" row map (base, L, G) {tuple(row['row_map'])}"
               if any(row["row_map"]) else "") + ": device "
            f"{row['device_ms']:.4f} ms ({share:.1%} of the "
            f"{row['bound_ms']:.4f} ms bound), events "
            f"{row['event_ms']:.4f} ms, one wrapper call {row['call_ms']:.4f}"
            f" ms, host {row['host_us']:.1f} us a call; "
            f"F.dropout device {lib['device_ms']:.4f} ms, events "
            f"{lib['event_ms']:.4f} ms")
    for name in compare:
        c = row[name]
        line += (f"; {name} device {c['device_ms']:.4f} ms, events "
                 f"{c['event_ms']:.4f} ms, host {c['host_us']:.1f} us")
    return line


if __name__ == "__main__":
    main()
