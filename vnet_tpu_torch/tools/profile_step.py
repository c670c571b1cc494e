"""Where the time of one training step goes, on the card.

    python -m vnet_tpu_torch.tools.profile_step [--batch 96] [--impl pallas]

Builds ``bench.py``'s flagship training step (the 3D V-Net of
``configs/config.json`` at full width, bf16, 64^3 patches, weighted
Sørensen, Adam, random data made from a seed as ``bench.py`` makes it),
times ``--steps`` steps after a warm-up one, then records one more with
``torch.profiler`` and prints the device time by kernel group, the device's
busy and idle share of the step, and the peak device memory. Device busy
time is the union of the intervals of the trace's device events (kernels,
copies, memsets); the span runs from the step's first host event to its
last device event. ``--impl`` sets ``DropoutImpl`` and ``DwImpl`` together.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from ..config import LossConfig, OptimizerConfig
from ..models import build_network
from ..train import TrainState, make_train_step
from ..train.optim import build_optimizer

PATCH = (64, 64, 64)
NUM_CLASSES = 3

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("dw_partial_kernel", "dW kernel"), ("dw_reduce_kernel", "dW kernel"),
    ("dropout_kernel", "dropout kernel"),
    ("multi_tensor", "optimizer"), ("adam", "optimizer"),
    ("conv", "cuDNN convolution"), ("xmma", "cuDNN convolution"),
    ("cutlass", "cuDNN convolution"), ("sm90", "cuDNN convolution"),
    ("implicit", "cuDNN convolution"), ("wgrad", "cuDNN convolution"),
    ("dgrad", "cuDNN convolution"),
    ("reduce", "reductions"), ("Memcpy", "copies"), ("Memset", "copies"),
)


def flagship_step(impl: str, batch: int, device="cuda", seed: int = 0):
    """``(state, step_fn, images, labels)`` of the flagship workload."""
    net = build_network("VNet", num_classes=NUM_CLASSES, dropout_rate=0.01,
                        norm="batch", dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(seed),
                        dropout_impl=impl, dw_impl=impl)
    opt, schedule = build_optimizer(
        OptimizerConfig(name="Adam", initial_learning_rate=1e-2,
                        decay_factor=0.99, decay_steps=100),
        net.parameters())
    step = make_train_step(
        LossConfig(name="weighted_sorensen", weights=(0.01, 0.1, 1.0)),
        NUM_CLASSES, schedule, compute_metrics=False)
    host = np.random.default_rng(seed)
    images = torch.from_numpy(host.normal(size=(batch,) + PATCH + (1,))
                              .astype(np.float32)).to(device)
    labels = torch.from_numpy(host.integers(
        0, NUM_CLASSES, size=(batch,) + PATCH).astype(np.int32)).to(device)
    return TrainState(net, opt), step, images, labels


def timed_steps(state, step, images, labels, n: int):
    """Host-clock ms of ``n`` synchronised steps and their losses."""
    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, images, labels, dropout_seed=state.step)
        losses.append(float(out.loss))
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def group_of(name: str) -> str:
    low = name.lower()
    for fragment, group in GROUPS:
        if fragment.lower() in low:
            return group
    return "elementwise and other"


def breakdown(prof):
    """``(span_ms, busy_ms, {group: ms}, {kernel name: (ms, count)})``."""
    device, host_start = [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((start, end, e.name))
        elif host_start is None or start < host_start:
            host_start = start
    device.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in device:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = max(e for _, e, _ in device) - min(host_start, device[0][0])
    groups, kernels = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        groups[group_of(name)] += (e - s) / 1e3
        kernels[name][0] += (e - s) / 1e3
        kernels[name][1] += 1
    return span / 1e3, busy / 1e3, dict(groups), dict(kernels)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "profile_step")
    parser.add_argument("--batch", type=int, default=96)
    parser.add_argument("--impl", default="pallas",
                        choices=["pallas", "bits8", "xla"])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    state, step, images, labels = flagship_step(args.impl, args.batch)
    torch.cuda.reset_peak_memory_stats()
    times, losses = timed_steps(state, step, images, labels, 1 + args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, images, labels, dropout_seed=state.step)
        torch.cuda.synchronize()
    span, busy, groups, kernels = breakdown(prof)
    print(f"card: {smi}")
    print(f"impl {args.impl}, batch {args.batch}, 64^3 bf16: step ms "
          f"{[round(t, 1) for t in times]} (first is warm-up), median "
          f"{statistics.median(times[1:]):.1f} ms, "
          f"{args.batch / statistics.median(times[1:]) * 1e3:.1f} "
          f"patches/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"losses {[round(v, 4) for v in losses]}")
    print(f"profiled step: span {span:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / span:.3f}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {ms:10.2f} ms  {ms / busy:6.1%} of busy")
    print("top kernels:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"  {ms:10.2f} ms  x{count:<4d} {name[:110]}")


if __name__ == "__main__":
    main()
