"""The flagship training step data-parallel on the card: R ranks against
one process.

    python -m vnet_tpu_torch.tools.dp_bench [--ranks R] [--backend nccl]
        [--device cuda] [--out FILE.json]

One process on the first card first, then ``R`` ranks (``parallel.launch``;
by default one a visible card under ``nccl``; ``--backend gloo --device
cuda:0`` puts them all on one card), each taking its rows of the same
global batches:

* (a) one float32 step (TF32 off) of the full-width packed flagship network
  (``profile_step.flagship_step``) at global batch ``CHECK_BATCH``, 64^3,
  ``pallas`` dropout 0.01 through the kernel and the dW kernel. The ranks'
  loss, gradients and running averages must agree with the one process's
  within ``RTOL`` of the largest entry of their kind; the parameters after
  Adam within ``RTOL`` beyond Adam's first-step amplification of the two
  runs' gradient difference (:func:`compare_train`); the ranks' parameters
  and averages bitwise equal to each other; every dropout layer's mask,
  joined over the ranks, bitwise the one process's; 42 dropout and 21 dW
  launches a rank.
* (b) the bf16 flagship step at global batch ``BATCH``: median ms of
  ``STEPS`` steps after a warm-up, peak memory and launches a step, a rank
  and in one process, and the global patches/s of each; and one process's
  step at a rank's share of the batch, which the ranks' step exceeds by
  what data parallelism adds (collectives, synchronisation). The ranks and
  the one process at a rank's share record one more step with
  ``torch.profiler``: device time by kernel group (``profile_step``'s
  groups; ``collectives`` are NCCL's kernels), busy and idle share.

``chip_smoke.py`` phase 20 runs both at two ``gloo`` ranks sharing one
card. Prints the card's name and power limit; exits non-zero when a check
fails. Needs a CUDA card.
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
from ..models.layers import Dropout
from ..ops.dropout import dropout_apply
from ..ops.dw_conv import dw_conv
from ..parallel import launch, make_mesh
from .profile_step import breakdown, flagship_step, timed_steps

CHECK_BATCH = 4  # (a): cut from 96 so the float32 step fits beside its twin
BATCH = 96  # (b): bench.py's batch
PATCH = (64, 64, 64)
STEPS = 3
SEED = 0
DROPOUT_SEED = 20261017
# (a): the same arithmetic summed in other orders (batch-norm moments and
# gradients in shares); allowed max |diff| relative to the largest entry of
# its kind
RTOL = 1e-4
# Adam's first update is exactly lr * g / (|g| + eps), about lr * sign(g):
# a gradient near 0 (a conv bias ahead of a batch norm, whose gradient is
# rounding, or a weight's that happens to be small) moves its parameter by
# up to lr whatever its sign or size, so two summation orders can put such
# a parameter up to 2 lr apart. A parameter's |diff| is held to that
# amplification of the two runs' gradients plus RTOL of the largest
LR = 1e-2  # flagship_step's Adam learning rate at step 0
ADAM_EPS = 1e-8
DROPOUT_LAYERS, DW_LAUNCHES = 21, 21  # the packed flagship's, a step


def _launches() -> dict:
    return {"dropout": dropout_apply.launches, "dw_conv": dw_conv.launches}


def launches_since(before: dict) -> dict:
    """The kernel launches since ``before`` (a :func:`_launches` reading);
    the counters themselves are never reset here, so a caller counting
    around a whole run sees every launch."""
    return {k: v - before[k] for k, v in _launches().items()}


def dropout_masks(net):
    """Forward hooks on every dropout layer of ``net``: per layer ``(shape,
    dropped, valid)``, the packed bits of ``dropped`` (output 0, input not
    0) and ``valid`` (input not 0) in the logical ``(B, C, *spatial)``
    order; ``(records, handles)``."""
    records = []

    def hook(module, inputs, out):
        x = inputs[0]
        records.append((tuple(x.shape),) + tuple(
            np.packbits(b.cpu().numpy().reshape(-1))
            for b in ((out == 0) & (x != 0), x != 0)))

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, Dropout)]
    return records, handles


def train_check(mesh=None, device="cuda", batch=CHECK_BATCH, patch=PATCH):
    """(a) on the rank's rows, and with a space axis its slab (the whole
    batch without ``mesh``): loss, metrics, gradients, state dict, dropout
    masks, launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state, step, images, labels = flagship_step(
            "pallas", batch, device=device, seed=SEED, mesh=mesh,
            dtype=torch.float32, compute_metrics=True, patch=patch)
        masks, handles = dropout_masks(state.network)
        before = _launches()
        out = step(state, images, labels, dropout_seed=DROPOUT_SEED)
        torch.cuda.synchronize()
        launches = launches_since(before)
        for h in handles:
            h.remove()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return dict(loss=float(out.loss),
                metrics={k: float(v) for k, v in out.metrics.items()},
                grads={k: p.grad.detach().cpu()
                       for k, p in state.network.named_parameters()},
                state={k: v.detach().cpu()
                       for k, v in state.network.state_dict().items()},
                masks=masks, launches=launches)


def step_timing(mesh=None, device="cuda", batch=BATCH,
                profile: bool = False):
    """(b) on the rank's rows of a global ``batch``: median ms of ``STEPS``
    steps after a warm-up, peak memory, losses, launches a step; with
    ``profile``, one more step's ``(span, busy, {group: ms})`` from a
    ``torch.profiler`` trace."""
    state, step, images, labels = flagship_step("pallas", batch,
                                                device=device, seed=SEED,
                                                mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    timed_steps(state, step, images, labels, 1)
    before = _launches()
    times, losses = timed_steps(state, step, images, labels, STEPS)
    out = dict(ms=statistics.median(times), times=times, losses=losses,
               peak=torch.cuda.max_memory_allocated(), rows=len(images),
               per_step={k: v / STEPS
                         for k, v in launches_since(before).items()})
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            timed_steps(state, step, images, labels, 1)
        out["profile"] = breakdown(prof)[:3]
    return out


def rank_results(mesh, profile: bool = False) -> dict:
    """(a) and (b) on this rank; rank 1 onwards keep no tensors of (a) but
    whether their parameters and averages equal rank 0's, bitwise;
    ``profile``: every rank traces one more step of (b) (its collectives
    need every rank), rank 0's is reported."""
    a = train_check(mesh, mesh.device)
    flat = torch.cat([v.float().reshape(-1) for v in a["state"].values()]
                     ).to(mesh.device)
    ref = flat.clone()
    dist.broadcast(ref, 0)
    a["ranks_equal"] = bool(torch.equal(ref, flat))
    if mesh.rank:
        del a["grads"], a["state"]
    torch.cuda.empty_cache()
    b = step_timing(mesh, mesh.device, profile=profile)
    torch.cuda.empty_cache()
    return {"rank": mesh.rank, "world": mesh.world_size, "train": a,
            "timing": b}


def adam_first(g: torch.Tensor) -> torch.Tensor:
    """Adam's first update direction (bias-corrected): g / (|g| + eps)."""
    return g / (g.abs() + ADAM_EPS)


def _max_rel(got, ref) -> float:
    scale = max(v.abs().max().item() for v in ref.values())
    return max((got[k] - v).abs().max().item() for k, v in ref.items()) / scale


def compare_train(ref, got):
    """(a)'s errors, each relative to its kind's largest reference entry, a
    parameter's beyond Adam's amplification of the gradients' difference;
    the entries that amplification allows past RTOL, and their max
    |diff|."""
    params = ref["grads"].keys()
    scale = max(ref["state"][k].abs().max().item() for k in params)
    excess, amplified, amp_err = 0.0, 0, 0.0
    for k in params:
        diff = (got["state"][k] - ref["state"][k]).abs()
        allow = LR * (adam_first(got["grads"][k])
                      - adam_first(ref["grads"][k])).abs()
        excess = max(excess, (diff - allow).max().item())
        wide = allow > RTOL * scale
        amplified += int(wide.sum())
        if wide.any():
            amp_err = max(amp_err, diff[wide].max().item())
    buffers = {k: v for k, v in ref["state"].items() if k not in params}
    errs = dict(
        loss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        gradients=_max_rel(got["grads"], ref["grads"]),
        parameters=max(excess, 0.0) / scale,
        running_averages=_max_rel({k: got["state"][k] for k in buffers},
                                  buffers))
    return errs, amplified, amp_err


def compare_masks(ref_masks, rank_masks):
    """Per dropout layer, the ranks' dropped bits joined against the one
    process's, on the elements whose input is nonzero in both runs:
    ``(layers, compared elements, mismatches)``."""
    compared = mismatched = 0
    for (*_, ref_drop, ref_valid), *parts in zip(ref_masks, *rank_masks):
        drop = np.unpackbits(np.concatenate([p[-2] for p in parts]))
        valid = np.unpackbits(np.concatenate([p[-1] for p in parts]))
        both = valid & np.unpackbits(ref_valid)
        compared += int(both.sum())
        mismatched += int(((drop ^ np.unpackbits(ref_drop)) & both).sum())
    return len(ref_masks), compared, mismatched


def report_train(ref, ranks, tag: str) -> list:
    """Print (a)'s comparison; return the failed checks."""
    errs, amplified, amp_err = compare_train(ref, ranks[0]["train"])
    layers, compared, mismatched = compare_masks(
        ref["masks"], [r["train"]["masks"] for r in ranks])
    per_rank = [r["train"]["launches"] for r in ranks]
    print(f"{tag} f32 full-width packed step, global batch {CHECK_BATCH} "
          f"64^3, pallas dropout 0.01 (kernel), {len(ranks)} ranks vs one "
          f"process: loss {ranks[0]['train']['loss']:.6f} vs "
          f"{ref['loss']:.6f}; max|diff| / max "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tolerance "
          f"{RTOL:g}; parameters beyond Adam's amplification of the "
          f"gradients' difference); {amplified} parameter entries where "
          f"that amplification exceeds the tolerance (gradients near 0), "
          f"max |diff| {amp_err:.2e} (at most 2 lr = {2 * LR:g}); ranks' "
          f"parameters and running averages bitwise equal "
          f"{[r['train']['ranks_equal'] for r in ranks]}; dropout masks: "
          f"{layers} layers, {compared} elements, {mismatched} differ; "
          f"launches per rank {per_rank}, one process {ref['launches']}",
          flush=True)
    expect = {"dropout": 2 * DROPOUT_LAYERS, "dw_conv": DW_LAUNCHES}
    checks = {
        f"ranks differ from one process: {errs}":
            max(errs.values()) <= RTOL,
        f"near-zero-gradient entries off by {amp_err}":
            amp_err <= 2 * LR * (1 + 1e-3),
        "the ranks' parameters differ":
            all(r["train"]["ranks_equal"] for r in ranks),
        f"dropout masks: {layers} layers, {mismatched} differ":
            layers == DROPOUT_LAYERS and compared > 0 and mismatched == 0,
        f"launches per rank {per_rank}, expected {expect}":
            all(c == expect for c in per_rank)}
    return [msg for msg, ok in checks.items() if not ok]


def report_timing(ranks, tag: str, one=None, share=None) -> list:
    """Print (b) a rank (and against ``one`` process's step at the global
    batch and at a rank's ``share`` of it); return the failed checks."""
    failed = []
    expect = {"dropout": 2 * DROPOUT_LAYERS, "dw_conv": DW_LAUNCHES}
    for r in ranks:
        t = r["timing"]
        print(f"{tag} rank {r['rank']}: bf16 flagship step, {t['rows']} of "
              f"{BATCH} rows 64^3, median {t['ms']:.1f} ms over {STEPS} "
              f"steps {[round(x, 1) for x in t['times']]}, peak memory "
              f"{t['peak'] / 2 ** 30:.2f} GiB, losses {t['losses']}, kernel "
              f"launches a step {t['per_step']}", flush=True)
        if t["rows"] != BATCH // len(ranks):
            failed.append(f"rank {r['rank']} took {t['rows']} rows")
        if not all(np.isfinite(t["losses"])):
            failed.append(f"losses {t['losses']}")
        if t["per_step"] != expect:
            failed.append(f"launches a step {t['per_step']}")
    if any(r["timing"]["losses"] != ranks[0]["timing"]["losses"]
           for r in ranks):
        failed.append("the ranks log different losses")
    slowest = max(r["timing"]["ms"] for r in ranks)
    line = (f"{tag} {len(ranks)} ranks: {BATCH / slowest * 1e3:.1f} "
            f"patches/s for the global batch (slowest rank's median "
            f"{slowest:.1f} ms)")
    if one is not None:
        line += (f"; one process {one['ms']:.1f} ms, "
                 f"{BATCH / one['ms'] * 1e3:.1f} patches/s, peak "
                 f"{one['peak'] / 2 ** 30:.2f} GiB: "
                 f"x{one['ms'] / slowest:.2f}")
    if share is not None:
        line += (f"; one process at a rank's {share['rows']} rows "
                 f"{share['ms']:.1f} ms, so data parallelism adds "
                 f"{slowest - share['ms']:.1f} ms a step")
    print(line, flush=True)
    for who, t in (("rank 0", ranks[0]["timing"]), ("one process at a "
                                                     "rank's share", share)):
        if t is not None and "profile" in t:
            span, busy, groups = t["profile"]
            print(f"{tag} profiled step, {who}: span {span:.2f} ms, busy "
                  f"{busy:.2f} ms, idle {1 - busy / span:.1%}; "
                  + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(
                      groups.items(), key=lambda kv: -kv[1])), flush=True)
    return failed


def _rank(out_dir: str, device: str) -> None:
    result = rank_results(make_mesh(device=device), profile=True)
    torch.save(result, os.path.join(out_dir, f"rank{result['rank']}.pt"))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.tools."
                                          "dp_bench")
    parser.add_argument("--ranks", type=int, default=0,
                        help="data-parallel ranks (0: every visible card)")
    parser.add_argument("--backend", default=None,
                        help="process-group backend (nccl on cards)")
    parser.add_argument("--device", default="cuda",
                        help="cuda: rank r on card r; cuda:K: every rank on "
                             "card K (gloo)")
    parser.add_argument("--out", help="also write the readings as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_bench needs a CUDA card")
    ranks = args.ranks or torch.cuda.device_count()
    smi = card_line()
    print(f"cards: {smi}", flush=True)
    ref = train_check()
    torch.cuda.empty_cache()
    one = step_timing()
    torch.cuda.empty_cache()
    share = step_timing(batch=BATCH // ranks, profile=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launch(_rank, ranks, backend=args.backend, device=args.device,
               init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
               args=(tmp, args.device))
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                              weights_only=False) for r in range(ranks)]
    failed = (report_train(ref, results, "[a]")
              + report_timing(results, "[b]", one, share))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cards": smi, "ranks": ranks, "one": one,
                       "share": share,
                       "timing": [r["timing"] for r in results],
                       "failed": failed}, f, indent=1)
    if failed:
        raise SystemExit("dp_bench: " + "; ".join(failed))


if __name__ == "__main__":
    main()
