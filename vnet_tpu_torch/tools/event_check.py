"""Does a busy host stretch ``dropout_bench``'s event time, or spoil its
profiler traces?

    python -m vnet_tpu_torch.tools.event_check [--tries N] [--out FILE.json]

``dropout_bench`` fails a row whose CUDA-event ms per launch is more than
``EVENT_MARGIN`` from its profiler device ms, where the input is at least
``CHECK_BYTES``. This tool reads, at the checked shapes nearest that margin
(launches of 50-200 us, against 14-25 us of host time a call), for the
kernel (``xla``) and ``F.dropout``: the device ms (``device_ms``, with the
traces it retook), then ``--tries`` event readings without the spin queue
(``event_ms(..., queue_cycles=0)``: the host's enqueue rate shows) and as
many with it (``event_ms``'s default), each as its worst relative distance
from the device ms. It does so with the host idle, then with twice as many
busy processes as the host has cores, and under that load runs the whole
``dropout_bench`` in a process of its own (its exit code and the tail of
its output). Prints one JSON line per reading and a summary.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import torch

from ..device import card_line
from . import dropout_bench as db

SHAPES = [(32, 64, 128, 128), (8, 128, 32, 32, 32), (96, 128, 16, 16, 32)]


def _busy(stop_at: float) -> None:
    while time.time() < stop_at:
        pass


def measure(load: str, tries: int):
    """One row per shape and function: device ms, retakes, and the event
    readings without and with the spin queue."""
    import torch.nn.functional as F

    from ..ops.dropout import dropout_apply, dropout_params

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dropout_params(db.RATE, "xla")
    rows = []
    for shape in SHAPES:
        xs = db._inputs(shape, gen)
        count = max(db.LAUNCHES, len(xs))
        fns = {"kernel": lambda i: dropout_apply(xs[i % len(xs)], 1234, 5,
                                                 *params),
               "F.dropout": lambda i: F.dropout(xs[i % len(xs)], db.RATE,
                                                training=True)}
        for name, fn in fns.items():
            dev, _, _, retakes = db.device_ms(fn, count, db.floor_ms(shape))
            plain = [db.event_ms(fn, count, 0) for _ in range(tries)]
            queued = [db.event_ms(fn, count) for _ in range(tries)]
            row = dict(load=load, shape=list(shape), fn=name, device_ms=dev,
                       retakes=retakes, unqueued_ms=plain, queued_ms=queued,
                       unqueued_worst=max(abs(t - dev) / dev for t in plain),
                       queued_worst=max(abs(t - dev) / dev for t in queued))
            print(json.dumps(row), flush=True)
            rows.append(row)
        del xs
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "event_check")
    parser.add_argument("--tries", type=int, default=5)
    parser.add_argument("--out", help="also write the readings as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("event_check needs a CUDA card")
    smi = card_line()
    print(f"card: {smi}", flush=True)
    rows = measure("idle", args.tries)
    cores = os.cpu_count() or 1
    load = f"{2 * cores} busy processes on {cores} cores"
    ctx = mp.get_context("spawn")
    busy = [ctx.Process(target=_busy, args=(time.time() + 900,))
            for _ in range(2 * cores)]
    for p in busy:
        p.start()
    try:
        rows += measure(load, args.tries)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vnet_tpu_torch.tools.dropout_bench"],
            capture_output=True, text=True, timeout=600)
        bench = dict(exit=proc.returncode, seconds=time.perf_counter() - t0,
                     tail=(proc.stdout + proc.stderr).splitlines()[-12:])
    finally:
        for p in busy:
            p.terminate()
        for p in busy:
            p.join()
    for tag in ("idle", load):
        mine = [r for r in rows if r["load"] == tag]
        print(f"{tag}: worst unqueued "
              f"{max(r['unqueued_worst'] for r in mine):.1%}, worst queued "
              f"{max(r['queued_worst'] for r in mine):.1%} from device ms "
              f"(check: {db.EVENT_MARGIN:.0%}); traces retaken "
              f"{sum(r['retakes'] for r in mine)}", flush=True)
    print(f"dropout_bench under load: exit {bench['exit']} in "
          f"{bench['seconds']:.1f} s", flush=True)
    print("\n".join(bench["tail"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, rows=rows, bench=bench), f, indent=1)


if __name__ == "__main__":
    main()
