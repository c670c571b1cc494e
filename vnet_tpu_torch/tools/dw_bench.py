"""The dW kernel's plans measured against each other and against cuDNN at
the flagship training step's weight-gradient shapes, on the card.

    python -m vnet_tpu_torch.tools.dw_bench [--batch 96] [--out FILE]

For each of the ten distinct stride-1 weight gradients of the flagship step
(``chip_smoke.py``'s ``DW_SHAPES``, bf16, random data from a seed), times
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
import dataclasses
import json
import os
import statistics
import subprocess

import torch

from ..ops.dw_conv import (BRICK_POSITIONS, MMA_TARGET_BLOCKS, dw_conv_plain,
                           launch, plan)

SHAPES = (  # (Ci, Co, side, k, launches per step)
    (16, 16, 64, 5, 1), (32, 16, 64, 5, 1), (32, 32, 32, 5, 3),
    (64, 32, 32, 5, 1), (64, 64, 16, 5, 5), (128, 64, 16, 5, 1),
    (128, 128, 8, 5, 5), (256, 128, 8, 5, 1), (256, 256, 4, 5, 3),
    (16, 3, 64, 1, 1))
RTOL = 1e-4


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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_bench needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cl = torch.channels_last_3d
    rows = []
    for ci, co, side, k, n in SHAPES:
        vol, ks = (side,) * 3, (k,) * 3
        x = torch.randn((args.batch, ci) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        g = torch.randn((args.batch, co) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        ref = dw_conv_plain(x, g, ks)
        scale = ref.abs().max().item()
        w = torch.empty((co, ci) + ks, dtype=torch.bfloat16, device="cuda")
        pad = ((k - 1) // 2,) * 3
        lib = time_ms(lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, (1, 1, 1), pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False)))
        flops = 2.0 * args.batch * side ** 3 * k ** 3 * ci * co
        for name, p in variants(args.batch, vol, ci, co, ks).items():
            err = (launch(x, g, ks, p) - ref).abs().max().item()
            ms = time_ms(lambda: launch(x, g, ks, p))
            ok = err <= RTOL * scale
            rows.append(dict(shape=[ci, co, side, k], per_step=n,
                             variant=name, plan=dataclasses.asdict(p), ms=ms,
                             tflops=flops / ms / 1e9, cudnn_ms=lib,
                             err_ratio=err / scale, ok=ok))
            print(f"{ci}->{co} k{k} {side}^3 x{n}: {name:34s} {p.regime:6s} "
                  f"tiles {p.tiles} brick {p.brick} ry {p.ry} "
                  f"threads {p.threads()} stages {p.stages} chunks "
                  f"{p.chunks}: {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s "
                  f"(cuDNN {lib:.3f} ms) err {err / scale:.2e} of max|dW|"
                  f"{'' if ok else ' OUT OF TOLERANCE'}", flush=True)
        del x, g, ref, w
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, batch=args.batch, rows=rows), f, indent=1)
    if not all(r["ok"] for r in rows):
        raise SystemExit("dw_bench: a plan is out of tolerance")


if __name__ == "__main__":
    main()
