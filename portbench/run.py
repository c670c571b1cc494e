"""One run of one cell:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's objects, the seed's weights and inputs, a warm-up
of the cell's own shapes), a window of ``--seconds``, the check against
the plain reference, then one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics of
``BENCHMARK.json``, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, also printed as the last lines of standard
error. No card, fewer cards than the cell asks for, or JAX or the JAX
package loaded by the time the window has closed: a non-zero exit and no
result.
"""

from __future__ import annotations

import time

CLOCK0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vnet_tpu")
CACHE = spec.ROOT / "_cache"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cache_environment() -> None:
    """Every build and kernel cache at a fixed directory in the checkout
    (the port builds its CUDA libraries into ``vnet_tpu_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_line(torch, chips: int, peak: int, reading=None) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak)}
    if reading is not None:
        out["busy_s"] = reading.busy_s
        out["window_s"] = reading.window_s
    return out


def result_line(cell, outcome, bench: dict, trace: bool, device: dict):
    """The run's result as a dict in the result line's key order; ``(line,
    checks)``."""
    from portbench.yardstick import compare

    chosen = spec.metrics_of(bench, cell.name)
    metrics = {}
    if trace:
        for m in chosen["per_layer"]:
            value = spec.metric_reader(m["name"]).read(outcome.reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in chosen["end_to_end"]:
            metrics[m["name"]] = {"value": outcome.metrics[m["name"]],
                                  "unit": m["unit"]}
    ok, checks = compare.verdict(outcome.numbers, cell.limits)
    line = {"correct": ok, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": outcome.reading.top_ops(10),
                             "idle_gaps": outcome.reading.gaps[:10]}
    line["checks"] = checks
    return line, checks


def main(argv=None) -> int:
    args = parse(argv)
    cache_environment()
    cell = spec.load_cell(args.workload)
    bench = spec.benchmark()
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import vnet_tpu_torch  # noqa: F401  (the program under test)
    outcome = cell.runner().run(cell, args.seed, args.seconds,
                                bool(args.trace), CLOCK0, "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    device = device_line(torch, cell.chips, outcome.memory_peak_bytes,
                         outcome.reading if args.trace else None)
    line, checks = result_line(cell, outcome, bench, bool(args.trace),
                               device)
    print(f"portbench: {cell.name} seed {args.seed}: setup_s "
          f"{outcome.metrics.get('setup_s')!r} window_s {outcome.window_s!r} "
          f"check_s {outcome.check_s!r}", file=sys.stderr)
    print(f"portbench: numbers {json.dumps(outcome.numbers)}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
