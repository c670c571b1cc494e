"""The dW kernel's plans measured against each other and against cuDNN at
the flagship training step's weight-gradient shapes, on the card.

    python -m vnet_tpu_torch.tools.dw_bench [--batch 96] [--out FILE]
        [--conv_impl packed|direct] [--list]

The shapes come from the network's module tree (:func:`dw_shapes`): the
flagship network built as ``tools/profile_step.py`` builds it, one training
step on the ``meta`` device at batch 1 with the dW wrapper's calls
recorded, scaled to ``--batch``. The packed network (the trainer's
default) has nine distinct weight gradients and 21 launches a step, the
direct one ten and 22. ``--list`` prints them, on any machine. For each
(bf16, random data from a seed), times
``ops/dw_conv.py::launch`` under the plan that :func:`plan` picks and under
alternatives: every block channel tile the channels allow, with bricks of
128, 256 and 512 positions per 16 x 16 warp slab and 2 or 3 bricks in
flight, and the planned plan with half the blocks. Each is checked against
the plain version within ``1e-4 * max|dW|``; cuDNN's weight gradient
(``aten.convolution_backward``) is timed beside them, all as CUDA-event
medians of 5. Prints one line per plan and writes all of it as JSON to
``--out``. The planner's defaults are the fastest of this grid on an H100.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import statistics
from collections import Counter

import torch

from ..device import card_line
from ..ops.dw_conv import (BRICK_POSITIONS, MMA_TARGET_BLOCKS, dw_conv_plain,
                           launch, plan)

RTOL = 1e-4
PATCH = (64, 64, 64)
# the module, not the function that vnet_tpu_torch.ops re-exports
_DW = importlib.import_module("vnet_tpu_torch.ops.dw_conv")


@contextlib.contextmanager
def recorded_dw():
    """Record ``(Ci, Co, vol, k)`` of every call of the dW wrapper, which
    returns an empty gradient of the right shape (``meta`` tensors)."""
    calls, real = [], _DW.dw_conv

    def record(x, g, ks):
        calls.append((x.shape[1], g.shape[1], tuple(x.shape[2:]), tuple(ks)))
        return torch.empty((g.shape[1], x.shape[1]) + tuple(ks),
                           device=x.device)

    _DW.dw_conv = record
    try:
        yield calls
    finally:
        _DW.dw_conv = real


def dw_shapes(conv_impl: str = "packed", patch=PATCH):
    """``[(Ci, Co, vol, k, launches per step)]`` of the flagship step's
    weight gradients, in the order the backward pass first meets them: one
    training step of the flagship network (``DwImpl: pallas``, dropout 0,
    which launches no dW) at batch 1 on the ``meta`` device."""
    from .profile_step import NUM_CLASSES
    from ..models import build_network

    net = build_network("VNet", num_classes=NUM_CLASSES, dropout_rate=0.0,
                        norm="batch", dtype=torch.bfloat16, device="meta",
                        dw_impl="pallas", conv_impl=conv_impl)
    net.train()
    with recorded_dw() as calls:
        net(torch.zeros((1,) + tuple(patch) + (1,), device="meta")
            ).sum().backward()
    return [s + (n,) for s, n in Counter(calls).items()]


def step_bound_ms(ci, co, vol, ks, batch, flops_per_s, bytes_per_s):
    """The least time of one weight gradient: its FLOPs at the bf16 peak or
    its bytes (x and g read once, the f32 dW written once) at the HBM rate,
    whichever is larger; ``(ms, flops, bytes)``."""
    positions = batch * math.prod(vol)
    flops = 2.0 * positions * math.prod(ks) * ci * co
    nbytes = positions * (ci + co) * 2 + co * ci * math.prod(ks) * 4
    return (max(flops / flops_per_s, nbytes / bytes_per_s) * 1e3, flops,
            nbytes)


def time_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def variants(batch, vol, ci, co, ks):
    """``{name: plan}``: the planner's, the planner's with half the blocks,
    and every tile with 128, 256 and 512 positions per slab and 2 or 3
    bricks in flight."""
    base = plan(batch, vol, ci, co, ks, torch.bfloat16)
    out = {"planned": base}
    if base.regime == "simt":
        return out
    out[f"blocks {MMA_TARGET_BLOCKS // 2}"] = plan(
        batch, vol, ci, co, ks, torch.bfloat16,
        target_blocks=MMA_TARGET_BLOCKS // 2)
    for tiles in ((16, 16), (16, 32), (32, 16)):
        if ci % tiles[0] or co % tiles[1]:
            continue
        slabs = tiles[0] * tiles[1] // 256
        for positions in (BRICK_POSITIONS // 2, BRICK_POSITIONS,
                          BRICK_POSITIONS * 2):
            for stages in (2, 3):
                out[f"{tiles} P {positions * slabs} stages {stages}"] = plan(
                    batch, vol, ci, co, ks, torch.bfloat16, tiles=tiles,
                    brick_positions=positions * slabs, stages=stages)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "dw_bench")
    parser.add_argument("--batch", type=int, default=96)
    parser.add_argument("--out", default="chiprun_out/dw_bench.json")
    parser.add_argument("--conv_impl", default="packed",
                        choices=("packed", "direct"))
    parser.add_argument("--list", action="store_true",
                        help="print the shapes and exit")
    args = parser.parse_args(argv)
    shapes = dw_shapes(args.conv_impl)
    if args.list:
        for ci, co, vol, ks, n in shapes:
            print(f"{ci}->{co} k{ks} at {vol} x{n} per step")
        return shapes
    if not torch.cuda.is_available():
        raise SystemExit("dw_bench needs a CUDA card")
    smi = card_line()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = torch.channels_last_3d
    rows = []
    for ci, co, vol, ks, n in shapes:
        x = torch.randn((args.batch, ci) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        g = torch.randn((args.batch, co) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        ref = dw_conv_plain(x, g, ks)
        scale = ref.abs().max().item()
        w = torch.empty((co, ci) + ks, dtype=torch.bfloat16, device="cuda")
        pad = tuple((k - 1) // 2 for k in ks)
        lib = time_ms(lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, (1, 1, 1), pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False)))
        flops = 2.0 * args.batch * math.prod(vol) * math.prod(ks) * ci * co
        for name, p in variants(args.batch, vol, ci, co, ks).items():
            err = (launch(x, g, ks, p) - ref).abs().max().item()
            ms = time_ms(lambda: launch(x, g, ks, p))
            ok = err <= RTOL * scale
            rows.append(dict(shape=[ci, co, list(vol), list(ks)], per_step=n,
                             variant=name, plan=dataclasses.asdict(p), ms=ms,
                             tflops=flops / ms / 1e9, cudnn_ms=lib,
                             err_ratio=err / scale, ok=ok))
            print(f"{ci}->{co} k{ks} {vol} x{n}: {name:30s} {p.regime:6s} "
                  f"tiles {p.tiles} brick {p.brick} ry {p.ry} "
                  f"threads {p.threads()} stages {p.stages} chunks "
                  f"{p.chunks}: {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s "
                  f"(cuDNN {lib:.3f} ms) err {err / scale:.2e} of max|dW|"
                  f"{'' if ok else ' OUT OF TOLERANCE'}", flush=True)
        del x, g, ref, w
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, batch=args.batch, conv_impl=args.conv_impl,
                       rows=rows), f, indent=1)
    if not all(r["ok"] for r in rows):
        raise SystemExit("dw_bench: a plan is out of tolerance")


if __name__ == "__main__":
    main()
