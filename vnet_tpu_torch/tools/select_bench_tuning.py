"""Pick the fastest measured training-step variant from A/B logs and write
it as a benchmark tuning file.

    python -m vnet_tpu_torch.tools.select_bench_tuning \
        [--log tmp/exp_r2b.log ...] [--out tmp/bench_tuning_torch.json]

The port's counterpart of ``scripts/select_bench_tuning.py``, over the
records of ``experiments/ab_train.py`` (one JSON line a tag; a tag
measured twice keeps its best patches/s). ``TAG_TO_TUNING`` maps each
landable tag to its knobs (``dropout_impl``, ``dw_impl``, ``scan``,
``batch``); ``nodrop`` and ``smoke`` tags are not landable. The bar is
the best incumbent measured (``INCUMBENTS``: the plain base, the scan-16
base, or the bits8 scan-16 settings under either tag); a variant wins
only if it beats that bar by more than 1%, else the incumbent stays. With
no ``base_b96_k4`` record nothing is written and the exit code is 1.
Prints the JSON line ``{"measured", "winner", "winner_pps",
"base_pps"}``, then the file written and ``WINNER_SELECTED``.

The file goes to ``--out`` only: the tuning in ``configs/`` belongs to
the JAX benchmark and is never written. The JAX script's recorded
fallbacks are TPU v5e figures and are not carried over; a winner's
``_source`` names its card (the record's ``card``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

TAG_TO_TUNING = {
    "base_b96_k4": {},
    "pdrop_b96_k4": {"dropout_impl": "pallas"},
    "cdw_b96_k4": {"dw_impl": "custom"},
    "base_b96_k8": {"scan": 8},
    "base_b96_k16": {"scan": 16},
    "base_b112_k4": {"batch": 112},
    "base_b128_k4": {"batch": 128},
    "drop8_b96_k4": {"dropout_impl": "bits8"},
    "drop8_b96_k16": {"dropout_impl": "bits8", "scan": 16},
    "base_b96_k24": {"scan": 24},
    "base_b96_k32": {"scan": 32},
    "base_b112_k16": {"batch": 112, "scan": 16},
    "base_b128_k16": {"batch": 128, "scan": 16},
    "pdw_b96_k16": {"dw_impl": "pallas", "dropout_impl": "bits8",
                    "scan": 16},
    "drop8_base_b96_k16": {"dropout_impl": "bits8", "scan": 16},
}
INCUMBENTS = ("base_b96_k4", "base_b96_k16", "drop8_b96_k16",
              "drop8_base_b96_k16")
LOGS = ("tmp/exp_r2b.log", "tmp/exp_r2e.log", "tmp/exp_r3tune.log",
        "tmp/exp_r4tune.log", "tmp/exp_r5tune.log")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_TUNING = os.path.join(REPO, "configs", "bench_tuning.json")


def collect(logs) -> dict:
    """``{tag: best record}`` over the logs' landable records."""
    results = {}
    for path in logs:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not (line.startswith("{") and "patches_per_s" in line):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                tag = rec.get("exp")
                best = results.get(tag)
                if tag in TAG_TO_TUNING and (
                        best is None
                        or rec["patches_per_s"] > best["patches_per_s"]):
                    results[tag] = rec
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", nargs="+", default=list(LOGS),
                    help="ab_train logs (default: the JAX script's five)")
    ap.add_argument("--out", default="tmp/bench_tuning_torch.json")
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(JAX_TUNING):
        ap.error(f"{args.out} is the JAX benchmark's tuning; write the "
                 f"port's elsewhere")

    records = collect(args.log)
    results = {tag: rec["patches_per_s"] for tag, rec in records.items()}
    if "base_b96_k4" not in results:
        print("no base measurement yet; not writing tuning", flush=True)
        return 1
    # the bar is the best incumbent measured: a lever must beat whatever
    # is already landed, not only the plain base
    base_tag = max((t for t in INCUMBENTS if t in results),
                   key=lambda t: results[t])
    base = results[base_tag]
    winner_tag, winner_pps = base_tag, base
    for tag, pps in results.items():
        if pps > winner_pps:
            winner_tag, winner_pps = tag, pps
    if winner_pps <= base * 1.01 and winner_tag != base_tag:
        print(f"fastest variant {winner_tag} ({winner_pps}) does not beat "
              f"base ({base}) by >1%; keeping base", flush=True)
        winner_tag, winner_pps = base_tag, base
    print(json.dumps({"measured": results, "winner": winner_tag,
                      "winner_pps": winner_pps, "base_pps": base}),
          flush=True)
    tuning = dict(TAG_TO_TUNING[winner_tag])
    tuning["_source"] = {"winner": winner_tag,
                         "patches_per_s": winner_pps,
                         "base_patches_per_s": base,
                         "card": records[winner_tag].get("card"),
                         "logs": list(args.log)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(tuning, f, indent=2)
    print(f"wrote {args.out}: {tuning}", flush=True)
    print("WINNER_SELECTED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
