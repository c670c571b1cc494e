"""The flagship training step spatially partitioned on the card: S ranks a
data row against one process.

    python -m vnet_tpu_torch.tools.sp_bench [--space S] [--patch X Y Z]
        [--batch B ...] [--one B ...] [--backend nccl] [--device cuda]
        [--out FILE.json]

One process on the first card first, then ``S`` ranks (``parallel.launch``;
by default one a visible card under ``nccl``; ``--backend gloo --device
cuda:0`` puts them all on one card), a ``1 x S`` grid: each rank holds its
slab of the first spatial axis of every patch (``Mesh.SpaceParallel``).

* ``--check``: (a) one float32 step (TF32 off) of the full-width packed
  flagship network (``profile_step.flagship_step``) at ``CHECK_BATCH``,
  64^3, ``pallas`` dropout 0.01 through the kernel: the ranks' loss and
  running averages within ``RTOL`` of the one process's, the gradients
  within ``GRAD_RTOL``, and no farther (beyond ``RTOL``) from the same
  step in float64 on the host's CPU (:func:`exact_check`) than the one
  process is,
  the parameters after Adam within Adam's first-step amplification
  (``dp_bench.compare_train``), the ranks' parameters bitwise equal to
  each other, every dropout layer's mask joined over the slabs bitwise
  the one process's, 42 dropout launches a rank.
* (b) the bf16 flagship step at each ``--batch`` and ``--patch``: median
  ms of ``STEPS`` steps after a warm-up, peak memory a rank, the halo
  exchanges a step (calls, MB sent a rank, host ms inside them), and one
  more step under ``torch.profiler``: device time by kernel group
  (``profile_step``'s groups; ``halo exchange`` is NCCL's point-to-point
  kernels) and the wall time their spans cover on the device timeline.
  ``--one`` times the one process at those batches (a batch one card
  holds).

``chip_smoke.py`` phase 23 runs (a) and (b) at two ``gloo`` ranks sharing
one card. Prints the card's name and power limit; exits non-zero when a
check fails. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..device import card_line
from ..parallel import halo, launch, make_mesh
from ..profiler import busy_union
from . import dp_bench
from .profile_step import breakdown, flagship_step, timed_steps

CHECK_BATCH = 2  # (a): the f32 step beside its twin on one card
PATCH = dp_bench.PATCH
STEPS = 3
SEED = 0
RTOL = dp_bench.RTOL
# (a)'s gradients: each float32 run of this step, the one process and the
# ranks alike, is 2.5e-4 of the largest gradient from the float64 step,
# in the weight gradients of the stride-2 convolutions ahead of batch norm,
# whose sums cancel (PERF.md); two such runs within twice RTOL, and
# the ranks no farther from the float64 step than the one process
GRAD_RTOL = 2 * RTOL


def train_check(mesh=None, device="cuda"):
    """(a) on the rank's slab (the whole batch without ``mesh``):
    ``dp_bench.train_check`` at ``CHECK_BATCH`` and ``PATCH``."""
    return dp_bench.train_check(mesh, device, CHECK_BATCH, PATCH)


def exact_check():
    """(a)'s one-process step in float64 on the host's CPU: the weights
    made in float32 as (a)'s and widened, the same inputs and dropout
    masks (the plain version), autograd's weight gradients. The yardstick
    of the float32 runs' rounding."""
    state, step, images, labels = flagship_step(
        "pallas", CHECK_BATCH, device="cpu", seed=SEED, dtype=torch.float32,
        compute_metrics=True, patch=PATCH, dw_impl="xla")
    state.network.double()
    masks, handles = dp_bench.dropout_masks(state.network)
    out = step(state, images.double(), labels,
               dropout_seed=dp_bench.DROPOUT_SEED)
    for h in handles:
        h.remove()
    return dict(loss=float(out.loss),
                grads={k: p.grad.detach()
                       for k, p in state.network.named_parameters()},
                state={k: v.detach()
                       for k, v in state.network.state_dict().items()},
                masks=masks)


def _worst_gradient(ref, got) -> str:
    """The parameter whose gradient differs most, and its max |diff| over
    its own largest entry."""
    diffs = {k: (got["grads"][k] - v).abs().max().item()
             for k, v in ref["grads"].items()}
    k = max(diffs, key=diffs.get)
    return (f"{k} {list(ref['grads'][k].shape)}, "
            f"{diffs[k] / ref['grads'][k].abs().max().item():.2e} of its "
            f"largest")


def _exchange_spans(prof):
    """``(device ms, wall ms)`` of the halo exchange's kernels in a trace:
    their summed durations and the union of their spans."""
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "sendrecv" in e.name.lower()]
    total = sum(b - a for a, b in spans) / 1e3
    return total, busy_union(spans) / 1e3


def step_timing(mesh=None, device="cuda", batch=8, patch=PATCH,
                profile: bool = False, hold=None):
    """(b) on the rank's slab of a batch of ``batch`` patches: median ms of
    ``STEPS`` steps after a warm-up, peak memory, losses, launches and halo
    exchanges a step; with ``profile``, one more step's trace readings.
    ``hold``: a context manager that one step runs inside before any of
    them (``chip_smoke.py`` holds that step's kernels against their plain
    versions), outside the peak memory and the times."""
    state, step, images, labels = flagship_step("pallas", batch,
                                                device=device, seed=SEED,
                                                mesh=mesh, patch=patch)
    if hold is not None:
        with hold:
            timed_steps(state, step, images, labels, 1)
    torch.cuda.reset_peak_memory_stats()
    timed_steps(state, step, images, labels, 1)
    before = dp_bench._launches()
    halo.STATS.update(calls=0, bytes=0, host_s=0.0)
    times, losses = timed_steps(state, step, images, labels, STEPS)
    out = dict(ms=statistics.median(times), times=times, losses=losses,
               peak=torch.cuda.max_memory_allocated(), rows=len(images),
               slab=tuple(images.shape[1:4]), batch=batch, patch=patch,
               per_step={k: v / STEPS
                         for k, v in dp_bench.launches_since(before).items()},
               exchange={"calls": halo.STATS["calls"] / STEPS,
                         "mb": halo.STATS["bytes"] / STEPS / 2 ** 20,
                         "host_ms": halo.STATS["host_s"] * 1e3 / STEPS})
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            timed_steps(state, step, images, labels, 1)
        out["profile"] = breakdown(prof)[:3]
        out["exchange"]["device_ms"], out["exchange"]["wall_ms"] = \
            _exchange_spans(prof)
    del state, step, images, labels
    torch.cuda.empty_cache()
    return out


def rank_results(mesh, check: bool = True, batches=(8,), patch=PATCH,
                 profile: bool = False) -> dict:
    """(a) (with ``check``) and (b) at each batch on this rank; rank 1
    onwards keep no tensors of (a) but whether their parameters and
    averages equal rank 0's, bitwise."""
    out = {"rank": mesh.rank, "world": mesh.world_size,
           "grid": (mesh.data_index, mesh.space_index)}
    if check:
        a = train_check(mesh, mesh.device)
        flat = torch.cat([v.float().reshape(-1) for v in a["state"].values()]
                         ).to(mesh.device)
        ref = flat.clone()
        dist.broadcast(ref, 0)
        a["ranks_equal"] = bool(torch.equal(ref, flat))
        if mesh.rank:
            del a["grads"], a["state"]
        torch.cuda.empty_cache()
        out["train"] = a
    out["timing"] = [step_timing(mesh, mesh.device, b, patch, profile)
                     for b in batches]
    return out


def compare_masks(ref_masks, rank_masks):
    """Per dropout layer, the slabs' dropped bits joined along the first
    spatial axis (``rank_masks`` in space order) against the one
    process's, on the elements whose input is nonzero in both runs:
    ``(layers, compared elements, mismatches)``."""
    compared = mismatched = 0
    for (shape, ref_drop, ref_valid), *parts in zip(ref_masks, *rank_masks):
        n = int(np.prod(shape))

        def joined(i):
            return np.concatenate([np.unpackbits(p[i])[:int(np.prod(p[0]))]
                                   .reshape(p[0]) for p in parts], axis=2)

        drop, valid = joined(1), joined(2)
        if drop.shape != shape:
            return len(ref_masks), compared, mismatched + n
        both = valid & np.unpackbits(ref_valid)[:n].reshape(shape)
        compared += int(both.sum())
        mismatched += int(((drop ^ np.unpackbits(ref_drop)[:n]
                            .reshape(shape)) & both).sum())
    return len(ref_masks), compared, mismatched


def report_train(ref, exact, ranks, tag: str) -> list:
    """Print (a)'s comparison with the one process ``ref`` and, for the
    gradients, of both with the float64 step ``exact``; return the failed
    checks."""
    errs, amplified, amp_err = dp_bench.compare_train(ref, ranks[0]["train"])
    e_ref = dp_bench.compare_train(exact, ref)[0]["gradients"]
    e_ranks = dp_bench.compare_train(exact, ranks[0]["train"])[0]["gradients"]
    layers, compared, mismatched = compare_masks(
        ref["masks"], [r["train"]["masks"] for r in ranks])
    per_rank = [r["train"]["launches"] for r in ranks]
    print(f"{tag} f32 full-width packed step, batch {CHECK_BATCH} 64^3 "
          f"split in {len(ranks)} slabs of the first axis, pallas dropout "
          f"0.01 (kernel), vs one process: loss "
          f"{ranks[0]['train']['loss']:.6f} vs {ref['loss']:.6f}; max|diff| "
          f"/ max { {k: f'{v:.2e}' for k, v in errs.items()} } (tolerance "
          f"{RTOL:g}, gradients {GRAD_RTOL:g}; parameters beyond Adam's "
          f"amplification of the gradients' difference), largest gradient "
          f"gap {_worst_gradient(ref, ranks[0]['train'])}; {amplified} "
          f"parameter entries where that amplification exceeds the "
          f"tolerance, max |diff| {amp_err:.2e}; gradients vs the float64 "
          f"step: one process {e_ref:.2e} ({_worst_gradient(exact, ref)}), "
          f"the ranks {e_ranks:.2e} (at most {RTOL:g} more); ranks' "
          f"parameters and running averages bitwise equal "
          f"{[r['train']['ranks_equal'] for r in ranks]}; dropout masks "
          f"joined over the slabs: {layers} layers, {compared} elements, "
          f"{mismatched} differ; launches per rank {per_rank}, one process "
          f"{ref['launches']}", flush=True)
    checks = {
        f"ranks differ from one process: {errs}":
            max(v for k, v in errs.items() if k != "gradients") <= RTOL
            and errs["gradients"] <= GRAD_RTOL,
        f"the ranks' gradients {e_ranks} from the float64 step, one "
        f"process's {e_ref}":
            e_ranks <= e_ref + RTOL,
        f"near-zero-gradient entries off by {amp_err}":
            amp_err <= 2 * dp_bench.LR * (1 + 1e-3),
        "the ranks' parameters differ":
            all(r["train"]["ranks_equal"] for r in ranks),
        f"dropout masks: {layers} layers, {mismatched} differ":
            layers == dp_bench.DROPOUT_LAYERS and compared > 0
            and mismatched == 0,
        f"dropout launches per rank {per_rank}":
            all(c["dropout"] == 2 * dp_bench.DROPOUT_LAYERS
                for c in per_rank)}
    return [msg for msg, ok in checks.items() if not ok]


def describe(t: dict) -> str:
    line = (f"batch {t['batch']} x {list(t['patch'])}, slab "
            f"{list(t['slab'])}: median {t['ms']:.1f} ms over {STEPS} steps "
            f"{[round(x, 1) for x in t['times']]}, peak memory "
            f"{t['peak'] / 2 ** 30:.2f} GiB, losses {t['losses']}, launches "
            f"a step {t['per_step']}")
    ex = t.get("exchange")
    if ex and ex["calls"]:
        line += (f"; halo exchanges a step {ex['calls']:.0f}, "
                 f"{ex['mb']:.1f} MB sent, host {ex['host_ms']:.1f} ms")
        if "device_ms" in ex:
            line += (f", device {ex['device_ms']:.2f} ms in kernels "
                     f"covering {ex['wall_ms']:.2f} ms of the timeline")
    if "profile" in t:
        span, busy, groups = t["profile"]
        line += (f"; profiled step span {span:.2f} ms, busy {busy:.2f} ms, "
                 f"idle {1 - busy / span:.1%}: " + ", ".join(
                     f"{g} {ms:.2f}" for g, ms in sorted(
                         groups.items(), key=lambda kv: -kv[1])))
    return line


def report_timing(ranks, tag: str, one=()) -> list:
    """Print (b) a rank and one process's; return the failed checks."""
    failed = []
    for r in ranks:
        for t in r["timing"]:
            print(f"{tag} rank {r['rank']}: {describe(t)}", flush=True)
            if not all(np.isfinite(t["losses"])):
                failed.append(f"rank {r['rank']} losses {t['losses']}")
    for i, t in enumerate(ranks[0]["timing"]):
        if any(r["timing"][i]["losses"] != t["losses"] for r in ranks):
            failed.append(f"the ranks log different losses at batch "
                          f"{t['batch']}")
    for t in one:
        print(f"{tag} one process: {describe(t)}", flush=True)
    return failed


def _rank(out_dir: str, device: str, check: bool, batches, patch) -> None:
    mesh = make_mesh(data_parallel=1, space_parallel=dist.get_world_size(),
                     device=device)
    result = rank_results(mesh, check, batches, patch, profile=True)
    torch.save(result, os.path.join(out_dir, f"rank{result['rank']}.pt"))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "sp_bench")
    parser.add_argument("--space", type=int, default=0,
                        help="space-parallel ranks (0: every visible card)")
    parser.add_argument("--patch", type=int, nargs=3, default=list(PATCH))
    parser.add_argument("--batch", type=int, nargs="+", default=[8],
                        help="(b)'s batches, split over the slabs")
    parser.add_argument("--one", type=int, nargs="*", default=[],
                        help="batches to time in one process too")
    parser.add_argument("--check", action="store_true",
                        help="run (a), the f32 check, at 64^3")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda: rank r on card r; cuda:K: every rank on "
                             "card K (gloo)")
    parser.add_argument("--out", help="also write the readings as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sp_bench needs a CUDA card")
    space = args.space or torch.cuda.device_count()
    patch = tuple(args.patch)
    smi = card_line()
    print(f"cards: {smi}", flush=True)
    ref = train_check() if args.check else None
    exact = exact_check() if args.check else None
    torch.cuda.empty_cache()
    one = [step_timing(batch=b, patch=patch, profile=True)
           for b in args.one]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launch(_rank, space, backend=args.backend, device=args.device,
               init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
               args=(tmp, args.device, args.check, tuple(args.batch), patch))
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              weights_only=False) for r in range(space)]
    failed = ((report_train(ref, exact, results, "[a]") if ref else [])
              + report_timing(results, "[b]", one))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cards": smi, "space": space, "patch": patch,
                       "one": one, "timing": [r["timing"] for r in results],
                       "failed": failed}, f, indent=1, default=str)
    if failed:
        raise SystemExit("sp_bench: " + "; ".join(failed))


if __name__ == "__main__":
    main()
