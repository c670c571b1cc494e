"""Training cells: the port's ``Trainer.train_step`` in a closed loop of
back-to-back steps on a pool of distinct host batches.

Set-up builds the ``Trainer`` from the configuration file, loads the
seed's weights into its network, makes the pool and takes the first
``checked_steps`` steps through the window's own call and feed (on
batches that all differ), which also warms up every shape. Each step, as
the trainer's loop makes it, is ``train_step`` (its host-to-device copy
included), a device synchronise and the previous step's loss read on the
host. The window then runs on the same object until ``--seconds`` have
passed; ``train_patches_per_s`` is all its patches over its wall time,
which ends with a synchronise. Afterwards the program is freed and the
reference takes the same steps from the same weights, batches and dropout
seeds.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.outcome import Outcome
from portbench.yardstick import compare, data, flops, nbytes
from portbench.yardstick.trace import read_chrome_trace

STEP_SPAN = "portbench.train_step"


def dropout_seed(seed: int, step: int) -> int:
    return data.sub_seed(seed, f"dropout{step}") & 0xFFFFFFFF


def build(cell, seed: int, device):
    """The trainer (a ``Trainer`` of the configuration, its network loaded
    with the seed's weights) and the weights on ``device``."""
    from vnet_tpu_torch.config import parse_config
    from vnet_tpu_torch.train.trainer import Trainer

    tree = cell.tree
    tree["TrainingSetting"]["Seed"] = int(seed) % (1 << 62)
    trainer = Trainer(parse_config(tree), device=device, log=False)
    ref = cell.reference()
    weights = data.make_weights(ref.named_shapes(cell.settings["network"]),
                                seed, device)
    trainer.network.load_state_dict(weights, strict=True)
    return trainer, weights


def pool(cell, seed: int, device) -> list:
    s = cell.settings
    net = s["network"]
    return [data.train_batch(seed, i, s["batch"], s["patch"],
                             net["in_channels"], net["num_classes"],
                             net["attention"], device)
            for i in range(int(cell.traffic["pool"]))]


def step(trainer, state, batch: dict, seed: int):
    return trainer.train_step(state, batch["images"], batch["labels"], seed,
                              batch.get("distance_maps"))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def checked_steps(trainer, state, batches, seeds, device) -> dict:
    """The first steps: losses, the first gradient's norms from Adam's
    state after one step, the parameters after the last (on the host)."""
    names = {id(p): n for n, p in trainer.network.named_parameters()}
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    out = {"losses": [], "grad_norms": None}
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        res = step(trainer, state, batch, seed)
        sync(device)
        out["losses"].append(float(res.loss))
        if i == 0:
            out["grad_norms"] = {
                names[id(p)]: float(st["exp_avg"].double().norm()) / (1 - beta1)
                for p, st in trainer.optimizer.state.items()}
    out["params"] = {n: p.detach().to("cpu", copy=True)
                     for n, p in trainer.network.named_parameters()}
    return out


class DropoutBytes:
    """The bytes the dropout kernel must move in a window, from forward
    hooks on the network's dropout layers: a forward (and a recompute's)
    launch and, for each forward outside a recompute, its backward launch,
    each ``yardstick.nbytes.dropout_launch`` of its tensor."""

    def __init__(self, network):
        from vnet_tpu_torch.models.layers import Dropout, recomputing

        self.recomputing = recomputing
        self.bytes = 0
        self.launches = 0
        self.handles = [m.register_forward_hook(self.hook)
                        for m in network.modules() if isinstance(m, Dropout)]

    def hook(self, module, inputs, output):
        if not (module.training and module.rate > 0.0):
            return
        n = 1 if self.recomputing() else 2
        self.launches += n
        self.bytes += n * nbytes.dropout_launch(output.numel(),
                                                output.element_size())

    def close(self):
        for h in self.handles:
            h.remove()


def window(trainer, state, batches, seeds, seconds: float, trace: bool,
           device):
    """Steps until ``seconds`` have passed: ``(steps, wall_s, prof,
    dropout_bytes)``."""
    counter = DropoutBytes(trainer.network) if trace else None
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    pending, steps = None, 0
    sync(device)
    t0 = time.perf_counter()
    while True:
        batch = batches[steps % len(batches)]
        seed = next(seeds)
        if trace:
            with record_function(STEP_SPAN):
                out = step(trainer, state, batch, seed)
        else:
            out = step(trainer, state, batch, seed)
        sync(device)
        if pending is not None:
            float(pending.loss)
        pending = out
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    float(pending.loss)
    sync(device)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        counter.close()
    return steps, wall, prof, counter


def traced(prof, wall: float, steps: int, work: dict):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        reading = read_chrome_trace(path, wall)
    reading.steps = steps
    reading.work = work
    return reading


def release() -> None:
    """Return the freed program's memory to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, clock0: float,
        device="cuda") -> Outcome:
    s = cell.settings
    n_checked = int(cell.traffic["checked_steps"])
    trainer, weights = build(cell, seed, device)
    state = trainer.init_state()
    batches = pool(cell, seed, device)
    if len(batches) < n_checked:
        raise ValueError("the pool must hold a distinct batch for every "
                         "checked step")
    seeds = [dropout_seed(seed, i) for i in range(n_checked)]
    prog = checked_steps(trainer, state, batches[:n_checked], seeds, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - clock0

    stream = (dropout_seed(seed, i) for i in range(n_checked, 1 << 62))
    rotated = batches[n_checked:] + batches[:n_checked]
    steps, wall, prof, counter = window(trainer, state, rotated, stream,
                                        seconds, trace, device)
    out = Outcome(attempted=steps, failed=0, window_s=wall)
    out.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if torch.device(device).type == "cuda" else 0)
    patches = steps * s["batch"]
    out.metrics = {"train_patches_per_s": patches / wall,
                   "setup_s": setup_s,
                   "peak_mem_gib": out.memory_peak_bytes / 2 ** 30}
    if trace:
        per_voxel = cell.reference().flops_per_voxel(s["network"])
        work = {"flops": steps * flops.train_step(per_voxel, s["batch"],
                                                  s["patch"]),
                "dropout_bytes": counter.bytes,
                "dropout_launches": counter.launches}
        out.reading = traced(prof, wall, steps, work)
    trainer.network = trainer.optimizer = None
    state.network = state.optimizer = None
    del trainer, state, prof, counter
    release()

    t_check = time.perf_counter()
    ref = cell.reference()
    ref.strict_float32()
    ref_out = ref.train(weights, s, batches[:n_checked], seeds,
                        ref.forward_loss(s), precision="float32",
                        steps=n_checked)
    out.numbers = compare.train_numbers(prog, ref_out, weights)
    out.check_s = time.perf_counter() - t_check
    return out


def readings(cell, seed: int, device="cuda", faults=()):
    """The check's numbers of one seed without a window (the control and
    the faults read the same way): ``{"program": numbers, <fault>:
    numbers}`` for each of ``faults`` (``control``: the reference in fp8
    in the program's place; ``half_batch``: the reference on half of each
    batch)."""
    s = cell.settings
    n = int(cell.traffic["checked_steps"])
    trainer, weights = build(cell, seed, device)
    state = trainer.init_state()
    batches = pool(cell, seed, device)[:n]
    seeds = [dropout_seed(seed, i) for i in range(n)]
    prog = checked_steps(trainer, state, batches, seeds, device)
    trainer.network = trainer.optimizer = None
    state.network = state.optimizer = None
    del trainer, state
    release()
    ref = cell.reference()
    ref.strict_float32()
    fl = ref.forward_loss(s)
    base = ref.train(weights, s, batches, seeds, fl, steps=n)
    base["params"] = {k: v.cpu() for k, v in base["params"].items()}
    out = {"program": compare.train_numbers(prog, base, weights)}
    for fault in faults:
        other = ref.train(weights, s, batches, seeds, fl, steps=n,
                          precision="fp8" if fault == "control"
                          else "float32",
                          half_batch=fault == "half_batch")
        out[fault] = compare.train_numbers(other, base, weights)
        del other
        release()
    return out

