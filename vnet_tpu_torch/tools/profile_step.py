"""Where the time of one training step goes, on the card.

    python -m vnet_tpu_torch.tools.profile_step [--batch 96] [--impl pallas]
    python -m vnet_tpu_torch.tools.profile_step --attention --batch 8 \
        --impl xla
    python -m vnet_tpu_torch.tools.profile_step --config2d --impl xla
    python -m vnet_tpu_torch.tools.profile_step --conv_impl direct
    python -m vnet_tpu_torch.tools.profile_step --group [--rounds 3]
    python -m vnet_tpu_torch.tools.profile_step --impl xla \
        --patch 256 256 32 --batch 32 24 16 [--remat]

Builds ``bench.py``'s flagship training step (the 3D V-Net of
``configs/config.json`` at full width, bf16, 64^3 patches, weighted
Sørensen, Adam, random data made from a seed as ``bench.py`` makes it), or
with ``--attention`` the attention-gated step of
``configs/config_attention_multimodal.json`` (the same backbone on two
modalities, attention heads of 64 channels, 2 classes, mixed Sørensen with
alpha 0.5 plus the l2 distance loss x100, random distance maps), or with
``--config2d`` the 2D step of ``configs/config_2d.json`` (the same network
at rank 2, 256^2 patches, 2 classes, Sørensen, batch 32 unless ``--batch``
says otherwise), times
``--steps`` steps after a warm-up one, then records one more with
``torch.profiler`` and prints the device time by kernel group, the device's
busy and idle share of the step, and the peak device memory. Device busy
time is the union of the intervals of the trace's device events (kernels,
copies, memsets); the span runs from the step's first host event to its
last device event. ``--impl`` sets ``DropoutImpl`` and ``DwImpl`` together;
``--conv_impl`` builds the packed network (the default, as the trainer
builds it) or the direct one. The profiled step's ``aten::copy_`` calls are
counted (layout copies among them). ``--find FRAGMENT`` names the operators
whose device kernels hold that fragment, with their input shapes (which
layer launched them), their launches and device ms. ``--group`` times the
flagship step at world size 1, inside a process group of one rank (``nccl``,
the trainer's mesh, as ``python -m vnet_tpu_torch --devices 0`` runs on one
card), against the same process's step without a process group, in turns
(none, group, group, none per round), and counts the collectives the
grouped steps call (there must be none). ``--remat`` builds the network
with ``Networks.Remat`` (its conv blocks, and the attention heads,
recomputed in the backward pass); ``--patch X Y Z`` sets the flagship
step's patch (``configs/config.json``'s step is ``--impl xla --patch 256
256 32 --batch 32``). Several ``--batch`` values run one after another; a
batch that does not fit in the card's memory is reported as such and the
next one runs. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from ..config import LossConfig, OptimizerConfig
from ..device import card_line
from ..models import build_network
from ..ops.dropout import dropout_apply
from ..ops.dw_conv import dw_conv
from ..parallel.mesh import batch_rows
from ..profiler import device_busy, group_of
from ..train import TrainState, make_train_step
from ..train.optim import build_optimizer

PATCH = (64, 64, 64)
NUM_CLASSES = 3
PATCH_2D = (256, 256)  # configs/config_2d.json
BATCH_2D = 32

CONV_IMPLS = ("packed", "direct")


def flagship_step(impl: str, batch: int, device="cuda", seed: int = 0,
                  patch=PATCH, conv_impl: str = "packed", mesh=None,
                  dtype=torch.bfloat16, compute_metrics: bool = False,
                  dw_impl=None, remat: bool = False,
                  dropout_rate: float = 0.01):
    """``(state, step_fn, images, labels)`` of the flagship workload;
    ``batch`` is the global batch, and with a ``mesh`` the step is the
    mesh's and the tensors are the rank's rows (and, with a space axis, its
    slab of the first spatial axis). ``dw_impl`` defaults to ``impl``;
    ``dropout_rate`` 0 takes dropout out (``experiments/ab_train.py``'s
    ``nodrop`` bound)."""
    net = build_network("VNet", num_classes=NUM_CLASSES,
                        dropout_rate=dropout_rate,
                        norm="batch", dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(seed),
                        dropout_impl=impl, dw_impl=dw_impl or impl,
                        conv_impl=conv_impl, remat=remat)
    opt, schedule = build_optimizer(
        OptimizerConfig(name="Adam", initial_learning_rate=1e-2,
                        decay_factor=0.99, decay_steps=100),
        net.parameters())
    step = make_train_step(
        LossConfig(name="weighted_sorensen", weights=(0.01, 0.1, 1.0)),
        NUM_CLASSES, schedule, compute_metrics=compute_metrics, mesh=mesh)
    host = np.random.default_rng(seed)
    lo, hi = (0, batch) if mesh is None else batch_rows(mesh, batch)
    s0, s1 = (0, patch[0]) if mesh is None else mesh.slab(patch[0])
    images = torch.from_numpy(host.normal(size=(batch,) + patch + (1,))
                              .astype(np.float32)[lo:hi, s0:s1]).to(device)
    labels = torch.from_numpy(host.integers(
        0, NUM_CLASSES, size=(batch,) + patch).astype(np.int32)[
            lo:hi, s0:s1]).to(device)
    return TrainState(net, opt), step, images, labels


def attention_step(impl: str, batch: int, device="cuda", seed: int = 0,
                   patch=PATCH, conv_impl: str = "packed",
                   remat: bool = False):
    """``(state, step_fn, images, labels)`` of the attention-gated step;
    ``step_fn`` carries the step's distance maps."""
    net = build_network("AttentionVNet", num_classes=2, in_channels=2,
                        dropout_rate=0.01, norm="batch", dtype=torch.bfloat16,
                        device=device,
                        generator=torch.Generator().manual_seed(seed),
                        dropout_impl=impl, dw_impl=impl, conv_impl=conv_impl,
                        remat=remat)
    opt, schedule = build_optimizer(
        OptimizerConfig(name="Adam", initial_learning_rate=1e-2,
                        decay_factor=0.99, decay_steps=100),
        net.parameters())
    raw = make_train_step(
        LossConfig(name="mixed_sorensen", weights=(), alpha=0.5,
                   attention_kind="l2", attention_scale=100.0),
        2, schedule, compute_metrics=False, is_attention=True)
    host = np.random.default_rng(seed)
    images = torch.from_numpy(host.normal(size=(batch,) + patch + (2,))
                              .astype(np.float32)).to(device)
    labels = torch.from_numpy((host.random((batch,) + patch) > 0.7)
                              .astype(np.int32)).to(device)
    dmaps = torch.from_numpy(host.random((batch,) + patch).astype(
        np.float32)).to(device)

    def step(state, images, labels, dropout_seed):
        return raw(state, images, labels, dropout_seed, dmaps)

    return TrainState(net, opt), step, images, labels


def config2d_step(impl: str, batch: int, device="cuda", seed: int = 0,
                  patch=PATCH_2D, conv_impl: str = "packed",
                  remat: bool = False):
    """``(state, step_fn, images, labels)`` of ``configs/config_2d.json``'s
    step: the 2D V-Net at full width (16 channels, 4 levels, convolutions
    (1, 2, 3, 3), bottom 3, PReLU, batch norm, dropout 0.01), bf16, 256^2
    patches, 2 classes, Sørensen, Adam 1e-2 decayed 0.99 every 100 steps."""
    net = build_network("VNet", num_classes=2, dropout_rate=0.01,
                        norm="batch", dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(seed),
                        dropout_impl=impl, dw_impl=impl, spatial_rank=2,
                        conv_impl=conv_impl, remat=remat)
    opt, schedule = build_optimizer(
        OptimizerConfig(name="Adam", initial_learning_rate=1e-2,
                        decay_factor=0.99, decay_steps=100),
        net.parameters())
    step = make_train_step(LossConfig(name="sorensen", weights=()), 2,
                           schedule, compute_metrics=False)
    host = np.random.default_rng(seed)
    images = torch.from_numpy(host.normal(size=(batch,) + patch + (1,))
                              .astype(np.float32)).to(device)
    labels = torch.from_numpy((host.random((batch,) + patch) > 0.7)
                              .astype(np.int32)).to(device)
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


COLLECTIVES = ("all_reduce", "broadcast", "barrier", "broadcast_object_list",
               "all_gather", "reduce_scatter")


def count_collectives():
    """Wrap ``torch.distributed``'s collectives with call counters; returns
    ``(counts, restore)``."""
    import torch.distributed as dist

    counts, real = defaultdict(int), {}
    for name in COLLECTIVES:
        real[name] = getattr(dist, name)

        def counted(*args, _name=name, **kwargs):
            counts[_name] += 1
            return real[_name](*args, **kwargs)

        setattr(dist, name, counted)

    def restore():
        for name, fn in real.items():
            setattr(dist, name, fn)

    return counts, restore


def group_vs_none(impl: str, batch: int, steps: int, rounds: int,
                  conv_impl: str):
    """``({"none": [ms], "group": [ms]}, collectives)``: the flagship step
    without a process group and at world size 1 inside one (a network of
    its own built there with the trainer's mesh, the same weights), timed
    in turns none, group, group, none, ``rounds`` times."""
    from ..parallel.mesh import launch, make_mesh

    plain = flagship_step(impl, batch, conv_impl=conv_impl)
    grouped = launch(lambda: flagship_step(impl, batch, conv_impl=conv_impl,
                                           mesh=make_mesh()), 1)
    timed_steps(*plain, 1)
    launch(lambda: timed_steps(*grouped, 1), 1)
    readings = {"none": [], "group": []}
    counts, restore = count_collectives()
    try:
        for _ in range(rounds):
            for kind in ("none", "group", "group", "none"):
                if kind == "none":
                    readings[kind] += timed_steps(*plain, steps)[0]
                else:
                    readings[kind] += launch(
                        lambda: timed_steps(*grouped, steps)[0], 1)
    finally:
        restore()
    return readings, dict(counts)


def breakdown(prof):
    """``(span_ms, busy_ms, {group: ms}, {kernel name: (ms, count)})``."""
    span, busy = device_busy(prof)
    groups, kernels = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            groups[group_of(e.name)] += ms
            kernels[e.name][0] += ms
            kernels[e.name][1] += 1
    return span, busy, dict(groups), dict(kernels)


def find_ops(prof, fragment: str):
    """``{(operator, input shapes, kernel): [ms, launches]}`` of the device
    kernels whose name holds ``fragment``, by the operator that launched
    them."""
    found = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        for k in e.kernels:
            if fragment.lower() in k.name.lower():
                key = (e.name, str(e.input_shapes), k.name)
                found[key][0] += k.duration / 1e3
                found[key][1] += 1
    return dict(found)


def profile(build, what, shape, args, batch, smi):
    """Time and profile one configuration at ``batch`` and print it."""
    kw = dict(conv_impl=args.conv_impl, remat=args.remat)
    if args.patch:
        kw["patch"] = tuple(args.patch)
    state, step, images, labels = build(args.impl, batch, **kw)
    torch.cuda.reset_peak_memory_stats()
    counters = (dropout_apply, dw_conv)
    before = [c.launches for c in counters]
    times, losses = timed_steps(state, step, images, labels, 1 + args.steps)
    launches = {c.__name__: (c.launches - b) / (1 + args.steps)
                for c, b in zip(counters, before)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                record_shapes=bool(args.find)) as prof:
        step(state, images, labels, dropout_seed=state.step)
        torch.cuda.synchronize()
    span, busy, groups, kernels = breakdown(prof)
    copies = sum(1 for e in prof.events() if e.name == "aten::copy_")
    print(f"card: {smi}")
    print(f"{what}, conv_impl {args.conv_impl}, impl {args.impl}, remat "
          f"{args.remat}, batch {batch}, {shape} bf16: step ms "
          f"{[round(t, 1) for t in times]} (first is warm-up), median "
          f"{statistics.median(times[1:]):.1f} ms, "
          f"{batch / statistics.median(times[1:]) * 1e3:.1f} "
          f"patches/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches a step {launches}; "
          f"losses {[round(v, 4) for v in losses]}")
    print(f"profiled step: span {span:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / span:.3f}; {copies} aten::copy_ calls")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {ms:10.2f} ms  {ms / busy:6.1%} of busy")
    print("top kernels:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"  {ms:10.2f} ms  x{count:<4d} {name[:110]}")
    if args.find:
        found = find_ops(prof, args.find)
        print(f"operators launching kernels that hold {args.find!r}: "
              f"{len(found)}")
        for (op, shapes, kernel), (ms, count) in sorted(
                found.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:10.2f} ms  x{count:<3d} {op} {shapes} -> "
                  f"{kernel[:80]}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "profile_step")
    parser.add_argument("--batch", type=int, nargs="+", default=None,
                        help="patches per step (96; 32 with --config2d); "
                             "several run in turn")
    parser.add_argument("--impl", default="pallas",
                        choices=["pallas", "bits8", "xla"])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--conv_impl", default="packed", choices=CONV_IMPLS,
                        help="the network's convolutions (the trainer's "
                             "default: packed)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the conv blocks (and attention "
                             "heads) in backward (Networks.Remat)")
    parser.add_argument("--patch", type=int, nargs="+", default=None,
                        help="the step's patch (default 64^3; 256^2 with "
                             "--config2d)")
    parser.add_argument("--find", default=None, metavar="FRAGMENT",
                        help="name the operators whose kernels hold it")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--attention", action="store_true",
                      help="the attention-gated step instead")
    mode.add_argument("--config2d", action="store_true",
                      help="configs/config_2d.json's 2D step instead")
    mode.add_argument("--group", action="store_true",
                      help="the flagship step in a process group of one "
                           "rank against none, in turns")
    parser.add_argument("--rounds", type=int, default=3,
                        help="--group: rounds of none, group, group, none")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    if args.attention:
        build, what = attention_step, "attention step"
    elif args.config2d:
        build, what = config2d_step, "config_2d.json step"
    else:
        build, what = flagship_step, "flagship step"
    default = PATCH_2D if args.config2d else PATCH
    shape = "x".join(map(str, args.patch or default))
    if args.batch is None:
        args.batch = [BATCH_2D if args.config2d else 96]
    smi = card_line()
    if args.group:
        print(f"card: {smi}")
        readings, collectives = group_vs_none(
            args.impl, args.batch[0], args.steps, args.rounds,
            args.conv_impl)
        for kind, ms in readings.items():
            q = statistics.quantiles(ms, n=4)
            print(f"flagship step, conv_impl {args.conv_impl}, impl "
                  f"{args.impl}, batch {args.batch[0]}, {kind:5s}: median "
                  f"{statistics.median(ms):.2f} ms, quartiles {q[0]:.2f} "
                  f"{q[2]:.2f}, min {min(ms):.2f} max {max(ms):.2f} over "
                  f"{len(ms)} steps: {[round(t, 2) for t in ms]}")
        print(f"collectives called by the grouped steps: {collectives}")
        return
    for batch in args.batch:
        try:
            profile(build, what, shape, args, batch, smi)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{what}, impl {args.impl}, remat {args.remat}, batch "
                  f"{batch}, {shape}: does not fit in the card's memory "
                  f"({str(e).splitlines()[0][:160]})")
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
