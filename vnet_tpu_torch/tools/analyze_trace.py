"""Summarize a ``torch.profiler`` Chrome trace: the card's busy time and
its kernels by accumulated device time.

    python -m vnet_tpu_torch.tools.analyze_trace TRACE_DIR [--top N] [--group]

The port's counterpart of ``scripts/analyze_trace.py``. TRACE_DIR holds
traces written by ``profiler.TraceCapture`` (``trace_*.json``: the CLI's
``--profile_dir``, the quickstart's window) or gzip'd ``*.json.gz``; the
newest one under it is read. Only the device's events count: complete
(``ph: "X"``) events of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``. Host operators, ``python_function`` events, runtime calls
and flow events are left out. Busy time is the union of the device
events' intervals (``profiler.busy_union``), so kernels that overlap on
two streams count once. Prints the trace's path, ``device busy time: X ms``
and the top ``N`` kernels by summed duration, with their launches and
kernel group (``profiler.group_of``); ``--group`` adds the summed time of
each group, which is at least the busy time where streams overlap.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import pathlib
import sys

from ..profiler import busy_union, group_of

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(trace_dir: str) -> pathlib.Path:
    root = pathlib.Path(trace_dir)
    paths = sorted([*root.rglob("trace_*.json"), *root.rglob("*.json.gz")],
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        raise SystemExit(f"no trace_*.json or *.json.gz under {trace_dir}")
    return paths[-1]


def read_events(path: pathlib.Path) -> list:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def summarize(events) -> dict:
    """``busy_ms`` (the union of the device events' intervals),
    ``{name: [ms, launches]}`` as ``ops`` and ``{group: ms}`` as
    ``groups`` over the device events of a Chrome trace."""
    ops = collections.defaultdict(lambda: [0.0, 0])
    starts = []
    for ev in events:
        if (ev.get("ph") != "X" or "dur" not in ev
                or ev.get("cat") not in DEVICE_CATEGORIES):
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        starts.append((ts, dur))
        op = ops[ev.get("name", "?")]
        op[0] += dur / 1e3
        op[1] += 1
    # Kineto's timestamps are microseconds since an epoch (~1e12 and
    # more), where a double's step is ~1e-4 us: ``ts + dur`` there rounds
    # each end, and the union could exceed the summed durations. Measured
    # from the first start, each interval keeps its own length.
    origin = min((ts for ts, _ in starts), default=0.0)
    spans = [(ts - origin, ts - origin + dur) for ts, dur in starts]
    groups = collections.defaultdict(float)
    for name, (ms, _) in ops.items():
        groups[group_of(name)] += ms
    return {"busy_ms": busy_union(spans) / 1e3, "events": len(spans),
            "ops": dict(ops), "groups": dict(groups)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--group", action="store_true",
                    help="add the summed device time of each kernel group")
    args = ap.parse_args(argv)

    path = find_trace(args.trace_dir)
    s = summarize(read_events(path))
    if not s["events"]:
        raise SystemExit(f"no device events in {path} (a trace of the "
                         f"card's activity: TraceCapture on a CUDA device)")
    busy = s["busy_ms"]
    print(f"trace: {path}")
    print(f"device busy time: {busy:.2f} ms across {s['events']} events\n")
    if args.group:
        print("by group (summed device time):")
        for group, ms in sorted(s["groups"].items(), key=lambda kv: -kv[1]):
            print(f"  {group:<22} {ms:>10.2f} ms  {100 * ms / busy:5.1f}%")
        print()
    print(f"top {args.top} ops:")
    ranked = sorted(s["ops"].items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (ms, n) in ranked:
        print(f"  {ms:>10.2f} ms  x{n:<5} [{group_of(name)}] {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
