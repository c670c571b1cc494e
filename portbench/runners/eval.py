"""Whole-volume evaluation cells: the port's ``Evaluator`` engine
(``SlidingWindowInference.__call__``) in a closed loop of one volume at a
time, from the host volume to its blended sums and blend weight copied back
to the host, the boundary of ``Evaluator.evaluate_single_3d``.

Set-up makes the seed's weights (their batch-norm running averages set to
the statistics of patches of the first volume, by the reference), builds
the ``Evaluator`` with them, makes the set of volumes (one of each depth
in ``depths``, in that order) and runs the largest once.
The window replays the set in order; the volume in flight when
``--seconds`` runs out is finished and counted. ``eval_mvox_per_s``: the
input voxels of every volume completed over the time from the window's
start to the last completion; ``eval_volume_p95_s``: the 95th percentile
of their latencies. Afterwards the program is freed and the reference
evaluates a sample of the volumes drawn from the seed.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.outcome import Outcome
from portbench.runners.train import release, sync, traced
from portbench.yardstick import compare, data, flops, nbytes
from portbench.yardstick.trace import quantile_p95

VOLUME_SPAN = "portbench.volume"


def volumes(cell, seed: int, device) -> list:
    """The set, one volume of each of ``depths`` in that order (the same
    sizes and order for every seed, so every seed's window holds the same
    work; the seed makes the values)."""
    t = cell.traffic
    return [data.volume(seed, i, (t["xy"][0], t["xy"][1], d),
                        cell.settings["network"]["in_channels"], device)
            for i, d in enumerate(t["depths"])]


def weights_for(cell, seed: int, first_volume: np.ndarray, device) -> dict:
    """The seed's weights, their running averages the statistics of
    ``calibrate_patches`` patches of ``first_volume`` (centred in x and y,
    spread along z), worked out in float32 without TF32."""
    s = cell.settings
    ref = cell.reference()
    weights = data.make_weights(ref.named_shapes(s["network"]), seed, device)
    px, py, pz = s["patch"]
    cx, cy = ((d - p) // 2 for d, p in zip(first_volume.shape, (px, py)))
    n = int(cell.traffic["calibrate_patches"])
    zs = np.linspace(0, first_volume.shape[2] - pz, n).astype(int)
    crops = [first_volume[cx:cx + px, cy:cy + py, z:z + pz] for z in zs]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ref.strict_float32()
    ref.calibrate(weights, s["network"],
                  torch.from_numpy(np.stack(crops)).to(device))
    # the program runs with its own settings
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved
    return weights


def build(cell, weights: dict, device):
    from vnet_tpu_torch.config import parse_config
    from vnet_tpu_torch.infer.evaluator import Evaluator

    return Evaluator(parse_config(cell.tree), state_dict=weights,
                     device=device)


def evaluate(evaluator, vol):
    """One volume through the engine, its sums and weight on the host."""
    acc, weight = evaluator.engine(vol)
    return acc.cpu().numpy(), weight.cpu().numpy()


def grid_work(cell, shape) -> dict:
    """Engine batches, real patches and blend bytes of one volume's grid
    (the grid padded to whole batches with its last row)."""
    s = cell.settings
    ref = cell.reference()
    patch, stride, bsz = s["patch"], s["eval"]["stride"], s["eval"]["batch"]
    axes = [ref.patch_starts(shape[a], patch[a], stride[a]) for a in range(3)]
    starts = [(x, y, z) for x in axes[0] for y in axes[1] for z in axes[2]]
    batches = math.ceil(len(starts) / bsz)
    starts += [starts[-1]] * (batches * bsz - len(starts))
    channels = 1 + s["network"]["num_classes"]
    blend = sum(nbytes.blend_launch(starts[i:i + bsz], patch, channels)
                for i in range(0, len(starts), bsz))
    return {"batches": batches, "patches": math.prod(len(a) for a in axes),
            "blend_bytes": blend}


def run(cell, seed: int, seconds: float, trace: bool, clock0: float,
        device="cuda") -> Outcome:
    s = cell.settings
    vols = volumes(cell, seed, device)
    weights = weights_for(cell, seed, vols[0], device)
    host_weights = {k: v.cpu() for k, v in weights.items()}
    evaluator = build(cell, weights, device)
    del weights
    largest = max(range(len(vols)), key=lambda i: vols[i].shape[2])
    evaluate(evaluator, vols[largest])
    sync(device)
    setup_s = time.perf_counter() - clock0

    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    kept, lat, done = {}, [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % len(vols)
        start = time.perf_counter()
        if trace:
            with record_function(VOLUME_SPAN):
                res = evaluate(evaluator, vols[k])
        else:
            res = evaluate(evaluator, vols[k])
        end = time.perf_counter()
        lat.append(end - start)
        done.append(k)
        kept.setdefault(k, res)
        i += 1
        if end - t0 >= seconds:
            break
    wall = end - t0
    if prof is not None:
        sync(device)
        prof.stop()
    out = Outcome(attempted=i, failed=0, window_s=wall)
    out.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if torch.device(device).type == "cuda" else 0)
    voxels = sum(math.prod(vols[k].shape[:3]) for k in done)
    out.metrics = {"eval_mvox_per_s": voxels / wall / 1e6,
                   "eval_volume_p95_s": quantile_p95(lat),
                   "setup_s": setup_s,
                   "peak_mem_gib": out.memory_peak_bytes / 2 ** 30}
    ref = cell.reference()
    if trace:
        works = [grid_work(cell, vols[k].shape) for k in done]
        work = {"flops": flops.forward(ref.flops_per_voxel(s["network"]),
                                       sum(w["patches"] for w in works),
                                       s["patch"]),
                "blend_bytes": sum(w["blend_bytes"] for w in works),
                "blend_launches": sum(w["batches"] for w in works)}
        out.reading = traced(prof, wall, work["blend_launches"], work)
    del evaluator, prof
    release()

    t_check = time.perf_counter()
    ref.strict_float32()
    w = {k: v.to(device) for k, v in host_weights.items()}
    order = [k for k in data.permutation(seed, "sample", len(vols))
             if k in kept][:int(cell.traffic["sampled_volumes"])]
    found = []
    for k in order:
        acc, weight = kept[k]
        r = ref.evaluate(w, vols[k], s["network"], s["patch"],
                         s["eval"]["stride"], s["eval"]["batch"],
                         s["eval"]["gaussian"])
        found.append(compare.eval_numbers(torch.from_numpy(acc),
                                          torch.from_numpy(weight), r))
        del r
        release()
    out.numbers = compare.worst(found) or {}
    out.check_s = time.perf_counter() - t_check
    return out


def readings(cell, seed: int, device="cuda", faults=()):
    """The check's numbers of one seed's sampled volumes without a window:
    ``{"program": numbers, "control": numbers}`` (the control: the
    reference in fp8 in the program's place)."""
    if set(faults) - {"control"}:
        raise ValueError(f"evaluation readings take the control only, not "
                         f"{sorted(set(faults) - {'control'})}")
    s = cell.settings
    vols = volumes(cell, seed, device)
    weights = weights_for(cell, seed, vols[0], device)
    evaluator = build(cell, weights, device)
    order = data.permutation(seed, "sample", len(vols))[
        :int(cell.traffic["sampled_volumes"])]
    outs = {k: evaluate(evaluator, vols[k]) for k in order}
    del evaluator
    release()
    ref = cell.reference()
    ref.strict_float32()
    found = {"program": []}
    for fault in faults:
        found[fault] = []
    args = (s["network"], s["patch"], s["eval"]["stride"], s["eval"]["batch"],
            s["eval"]["gaussian"])
    for k in order:
        base = ref.evaluate(weights, vols[k], *args)
        acc, weight = outs[k]
        found["program"].append(compare.eval_numbers(
            torch.from_numpy(acc), torch.from_numpy(weight), base))
        for fault in faults:
            other = ref.evaluate(weights, vols[k], *args, precision="fp8")
            found[fault].append(compare.eval_numbers(
                other[..., 1:], other[..., 0], base))
            del other
        del base
        release()
    return {k: compare.worst(v) for k, v in found.items()}
