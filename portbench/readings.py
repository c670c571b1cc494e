"""The two readings each limit of a cell's check is set from, in one
process on the card:

    python3 -m portbench.readings --workload <cell> --seeds S1 S2 ... \
        [--faults control half_batch] [--faulted N] [--out FILE]

For every seed the program's numbers (its first steps, or its sampled
volumes, as a run compares them, without a window); for the first
``--faulted`` seeds also each fault's: ``control`` is the reference in fp8
in the program's place, ``half_batch`` (training) the reference on half
of each batch. One JSON line a seed, then a summary: the largest program
reading of each number (the lower reading) and the smallest of each fault
(its upper reading). The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import spec
from portbench.run import cache_environment


def summary(lines: list) -> dict:
    out = {"program_max": {}, "faults_min": {}}
    for line in lines:
        for who, numbers in line["readings"].items():
            for k, v in numbers.items():
                if who == "program":
                    out["program_max"][k] = max(
                        out["program_max"].get(k, v), v)
                else:
                    d = out["faults_min"].setdefault(who, {})
                    d[k] = min(d.get(k, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--faulted", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cache_environment()
    cell = spec.load_cell(args.workload)
    runner = cell.runner()
    lines = []
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            faults = tuple(args.faults) if i < args.faulted else ()
            t0 = time.perf_counter()
            found = runner.readings(cell, seed, "cuda", faults)
            line = {"workload": cell.name, "seed": seed, "readings": found,
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
        text = json.dumps({"workload": cell.name, "summary": summary(lines)})
        print(text)
        if sink:
            sink.write(text + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
