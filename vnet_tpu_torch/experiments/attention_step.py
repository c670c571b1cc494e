"""Attention-gated V-Net step timing of the port, over a ladder of (side,
batch, remat) configurations — counterpart of the repo's
``scripts/experiments/attention_step.py``.

Each configuration trains the attention-gated V-Net (the flagship backbone
at full width: 16 channels, 4 levels, convolutions (1, 2, 3, 3), bottom 3,
dropout 0.01, PReLU, batch norm, bf16, packed at 128 lanes; 2 classes, one
modality) with Adam 1e-3 on random data made from seed 0, on the loss of
the reference's attention trainer: weighted Sørensen (0.1, 1.0) plus 100 x
the l2 distance loss of the attention logits. Blocks of ``SCAN_K`` steps
are timed after a first block (kernel builds, cuDNN's first calls); one
JSON line a configuration, also appended to ``--log``:

    {"exp": "attn_s64_b8_remat", "patches_per_s": N, "step_ms": N,
     "peak_gib": N, ...}

A configuration that does not fit in the card's memory is recorded with
its failure (``torch.cuda.OutOfMemoryError``) and the ladder goes on to the
next one; a tag already in the log (measured or failed) is not run again.
The TPU's device probe and one-child-process-a-configuration supervision
are not ported (the compile helper's crashes they guard against do not
exist here). ``--smoke`` runs 16^3 at batch 1 without and with ``Remat``
on the CPU, at a narrow width (4 channels, 2 levels, heads of 8
channels): it checks the plumbing, not the network.

    python -m vnet_tpu_torch.experiments.attention_step --log tmp/attn.log
    python -m vnet_tpu_torch.experiments.attention_step --log tmp/s.log \\
        --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# (tag, side, batch, remat), the JAX script's ladder, most ambitious first
CONFIGS = [
    ("attn_s64_b8_remat", 64, 8, True),
    ("attn_s64_b16_remat", 64, 16, True),
    ("attn_s48_b8", 48, 8, False),
    ("attn_s48_b8_remat", 48, 8, True),
    ("attn_s64_b8", 64, 8, False),
]
SCAN_K = 2  # steps a timed block, the JAX script's scan length
NUM_CLASSES = 2  # the legacy attention trainer is binary
# the JAX script's network, and the smoke's narrow one
NETWORK = dict(num_channels=16, num_levels=4, num_convolutions=(1, 2, 3, 3),
               bottom_convolutions=3, attention_channels=64)
SMOKE_NETWORK = dict(num_channels=4, num_levels=2, num_convolutions=(1, 2),
                     bottom_convolutions=1, attention_channels=8)


def measure(side: int, batch: int, remat: bool, reps: int, device: str,
            network: dict = NETWORK):
    """Median block time of ``reps`` blocks of ``SCAN_K`` steps after a
    first one, of the attention network of widths ``network``; peak
    memory on a card."""
    import numpy as np
    import torch

    from ..config import LossConfig, OptimizerConfig
    from ..models import build_network
    from ..train import TrainState, make_train_step
    from ..train.optim import build_optimizer

    net = build_network("AttentionVNet", num_classes=NUM_CLASSES,
                        **network,
                        dropout_rate=0.01, activation="prelu", norm="batch",
                        dtype=torch.bfloat16, conv_impl="packed",
                        packed_target_lanes=128, remat=remat, device=device,
                        generator=torch.Generator().manual_seed(0))
    opt, schedule = build_optimizer(
        OptimizerConfig(name="Adam", initial_learning_rate=1e-3,
                        decay_factor=1.0, decay_steps=1), net.parameters())
    step = make_train_step(
        LossConfig(name="weighted_sorensen", weights=(0.1, 1.0),
                   attention_kind="l2", attention_scale=100.0),
        NUM_CLASSES, schedule, compute_metrics=False, is_attention=True)
    host = np.random.default_rng(0)
    patch = (side,) * 3
    images = torch.from_numpy(host.normal(size=(batch, *patch, 1)).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(host.integers(
        0, NUM_CLASSES, size=(batch, *patch)).astype(np.int32)).to(device)
    dist = torch.from_numpy(host.random(size=(batch, *patch)).astype(
        np.float32)).to(device)
    state = TrainState(net, opt)
    cuda = torch.device(device).type == "cuda"

    def block():
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SCAN_K):
            out = step(state, images, labels, state.step, dist)
        float(out.loss)
        return time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first_s = block()
    times = sorted(block() for _ in range(reps))
    dt = times[len(times) // 2]
    return {
        "patches_per_s": round(batch * SCAN_K / dt, 3),
        "step_ms": round(dt / SCAN_K * 1000, 2),
        "first_block_s": round(first_s, 1),
        "peak_gib": (round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
                     if cuda else None),
        "batch": batch, "side": side, "remat": remat,
        "times_s": [round(t, 4) for t in times],
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def _configs(smoke: bool):
    if smoke:
        return [("attn_smoke", 16, 1, False),
                ("attn_smoke_remat", 16, 1, True)]
    return CONFIGS


def _logged_tags(log_path):
    """Tags already recorded (measured or failed): both are terminal."""
    tags = set()
    if not os.path.exists(log_path):
        return tags
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    tags.add(json.loads(line).get("exp"))
                except ValueError:
                    continue
    return tags


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.experiments.attention_step")
    ap.add_argument("--log", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of config tags to run")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (16^3 b1, with and without remat) "
                         "on the CPU, for plumbing verification")
    args = ap.parse_args(argv)
    device = "cpu" if args.smoke else "cuda"
    from ..device import resolve_device

    resolve_device(device)
    import torch

    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    done = _logged_tags(args.log)
    for tag, side, batch, remat in _configs(args.smoke):
        if args.only and tag not in args.only:
            continue
        if tag in done:
            print(f"{tag}: already in {args.log}; skipping", flush=True)
            continue
        try:
            rec = {"exp": tag, **measure(
                side, batch, remat, args.reps, device,
                SMOKE_NETWORK if args.smoke else NETWORK)}
        except torch.cuda.OutOfMemoryError as e:
            rec = {"exp": tag,
                   "error": f"{type(e).__name__}: {str(e)[:300]}",
                   "batch": batch, "side": side, "remat": remat}
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.log, "a") as f:
            f.write(line + "\n")
        if device == "cuda":
            import gc

            gc.collect()
            torch.cuda.empty_cache()
    measured = 0
    with open(args.log) as f:
        for line in f:
            if line.strip().startswith("{") and "patches_per_s" in line:
                measured += 1
    return 0 if measured else 1


if __name__ == "__main__":
    sys.exit(main())
