"""Whole-volume inference latency: a 512^3 volume through the sliding
window, on the card.

    python -m vnet_tpu_torch.tools.benchmark_eval [--size 512] [--patch 64]
        [--stride 64] [--batch 128] [--classes 3] [--gaussian]
        [--blend-impl xla|pallas] [--reps 3] [--device cuda]

The port's counterpart of ``scripts/benchmark_eval.py``, with its flags,
defaults, network and printed lines: the packed V-Net (16 channels, 4
levels, convolutions (1, 2, 3, 3), bottom 3, PReLU, batch norm, bf16,
``packed_target_lanes`` 128) in eval mode with random weights from seed 0,
and a volume drawn by ``np.random.default_rng(0).normal``. The volume is
put on the device before timing and the copy is reported on its own line;
the engine then takes the resident tensor in place
(``SlidingWindowInference.device_volume``). The first call (the blend
kernel's build, cuDNN's warm-up) is reported apart from the ``--reps``
timed ones, each of which includes the argmax and ends in a scalar fetch
(``.item()``), as the JAX script's ``float(jnp.max(label))``. A JSON line
follows the printed ones: the median and every rep's seconds, the copy's
and the first call's seconds, the peak device memory, the blend kernel's
launches over the run, and the card's name and power limit
(``nvidia-smi``). ``--device cuda`` (the default) raises where torch sees
no card; ``--device cpu`` runs the same path on the CPU (the blend's plain
version), where the device readings are null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..device import card_line, resolve_device
from ..infer.sliding_window import SlidingWindowInference
from ..models import build_network, eval_apply
from ..ops.blend import blend_accumulate_patches


def flagship_network(classes: int, device="cuda", dtype=torch.bfloat16,
                     seed: int = 0, spatial_rank: int = 3):
    """The JAX scripts' network: the packed full-width V-Net, dropout 0,
    weights from ``seed``."""
    return build_network("VNet", num_classes=classes, num_channels=16,
                         num_levels=4, num_convolutions=(1, 2, 3, 3),
                         bottom_convolutions=3, dropout_rate=0.0,
                         activation="prelu", norm="batch", dtype=dtype,
                         device=device, conv_impl="packed",
                         packed_target_lanes=128, spatial_rank=spatial_rank,
                         generator=torch.Generator().manual_seed(seed))


def build_engine(patch: int, stride: int, batch: int, classes: int,
                 gaussian: bool = False, blend_impl: str = "xla",
                 device="cuda", dtype=torch.bfloat16, seed: int = 0):
    """``(engine, network)``: ``flagship_network`` in eval mode behind a
    ``SlidingWindowInference`` over cubic ``patch`` and ``stride``."""
    net = flagship_network(classes, device, dtype, seed)
    engine = SlidingWindowInference(
        lambda patches: eval_apply(net, patches), (patch,) * 3,
        (stride,) * 3, batch, classes, gaussian_blend=gaussian,
        blend_impl=blend_impl, device=device)
    return engine, net


def resident_volume(size: int, device, seed: int = 0):
    """``(volume, seconds)``: the JAX script's ``(size,)*3 + (1,)`` volume
    on ``device``, and the seconds of its copy there, ended by a scalar
    fetch."""
    host = np.random.default_rng(seed).normal(
        size=(size,) * 3 + (1,)).astype(np.float32)
    t0 = time.perf_counter()
    vol = torch.from_numpy(host).to(device)
    vol[0, 0, 0].sum().item()
    return vol, time.perf_counter() - t0


def timed_reps(engine, vol, reps: int):
    """``(first call s, [rep s])``: each rep is the engine call, the argmax
    and a scalar fetch."""
    t0 = time.perf_counter()
    acc, w = engine(vol)
    w.sum().item()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc, w = engine(vol)
        label = torch.argmax(acc, -1)
        label.max().item()
        times.append(time.perf_counter() - t0)
    return first, times


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--patch", type=int, default=64)
    p.add_argument("--stride", type=int, default=64)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--gaussian", action="store_true")
    p.add_argument("--blend-impl", default="xla", choices=["xla", "pallas"])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    engine, _ = build_engine(args.patch, args.stride, args.batch,
                             args.classes, args.gaussian, args.blend_impl,
                             device=dev)
    vol, copy_s = resident_volume(args.size, dev)
    print(f"host->device transfer: {copy_s:.2f}s", flush=True)

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    launches = blend_accumulate_patches.launches
    first, times = timed_reps(engine, vol, args.reps)
    launches = blend_accumulate_patches.launches - launches
    print(f"first call (compile + run): {first:.2f}s", flush=True)
    med = statistics.median(times)
    print(f"{args.size}^3 sliding window stride={args.stride} "
          f"batch={args.batch} gaussian={args.gaussian} "
          f"blend={args.blend_impl}: "
          f"median {med:.2f}s over {args.reps} reps", flush=True)
    out = {"benchmark_eval": {
        "size": args.size, "patch": args.patch, "stride": args.stride,
        "batch": args.batch, "classes": args.classes,
        "gaussian": args.gaussian, "blend_impl": args.blend_impl,
        "device": str(dev), "median_s": med, "times_s": times,
        "first_call_s": first, "copy_s": copy_s,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if on_card else None),
        "blend_launches": launches, "card": card_line()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
