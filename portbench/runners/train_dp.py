"""Data-parallel training cells: the port's ``Trainer.train_step`` on every
card of the host, one rank a card, in a closed loop, as the trainer's
``Mesh.DataParallel`` runs it.

The workload's ``traffic`` sets ``ranks``, ``remat`` and
``data_parallel``, applied to the frozen configuration's tree
(``Networks.Remat``, ``Mesh.DataParallel``). The ranks run through the
port's ``parallel.mesh.launch`` (``nccl``, one process a card; ``gloo`` on
the CPU). Each rank builds the ``Trainer`` from the tree, loads the seed's
weights, makes the pool of global batches from the seed and takes its own
rows of each (``Trainer.rows``); batch statistics and gradients are
all-reduced by the trainer. The first ``checked_steps`` steps are the
check's and the warm-up; then every rank steps on the rotated pool until
rank 0's clock has passed ``--seconds``: after every ``STOP_EVERY`` steps
rank 0 tells the others whether it has, over a host-side ``gloo`` group
(no extra collective on the cards, and none inside the other steps). Each
step, as in ``runners/train.py``, is ``train_step``, a device synchronise
and the previous loss read.

``train_patches_per_s`` is every row of the global batch of every window
step over rank 0's window, which ends with a synchronise; ``setup_s`` runs
from the harness's first line to rank 0's window; ``peak_mem_gib`` is the
largest rank's allocator peak. With ``--trace 1`` rank 0 alone is traced,
and the reading's work is rank 0's share (its rows' model FLOPs, its
dropout launches). The check compares rank 0's first gradient (from Adam's
state after one step, the ranks' average) and parameters after the
checked steps with the configuration's reference taking the same steps on
the whole global batch on one card, after the ranks have exited.

``readings`` also reads the program with one exchange between the cards
taken out (``PROGRAM_FAULTS``): ``no_grad_allreduce``, each rank steps on
its own rows' gradient; ``no_moments_allreduce``, each batch norm takes
its own rank's moments.
"""

from __future__ import annotations

import contextlib
import copy
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import spec
from portbench.outcome import Outcome
from portbench.runners import train
from portbench.yardstick import compare, data, flops

STOP_EVERY = 8  # window steps between two agreements on the stop
PROGRAM_FAULTS = ("no_grad_allreduce", "no_moments_allreduce")


def dp_cell(cell) -> spec.Cell:
    """``cell`` with the traffic's ``remat`` and ``data_parallel`` set in
    its configuration's tree."""
    config = copy.deepcopy(cell.config)
    ts = config["settings"]["TrainingSetting"]
    ts["Networks"]["Remat"] = bool(cell.traffic["remat"])
    ts["Mesh"] = dict(ts.get("Mesh", {}),
                      DataParallel=int(cell.traffic["data_parallel"]))
    return spec.Cell(cell.name, cell.workload, config)


def _device(device: str) -> torch.device:
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _window(trainer, state, batches, seeds, seconds, trace, dev, stop):
    """Steps until rank 0's clock passes ``seconds``: ``(steps, wall_s,
    prof, dropout counter)``, the last two on a traced rank 0 only."""
    rank0 = dist.get_rank() == 0
    counter = train.DropoutBytes(trainer.network) if trace and rank0 else None
    prof = None
    if counter is not None:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    flag = torch.zeros(1, dtype=torch.int32)
    pending, steps = None, 0
    train.sync(dev)
    t0 = time.perf_counter()
    while True:
        batch = batches[steps % len(batches)]
        seed = next(seeds)
        if prof is not None:
            with record_function(train.STEP_SPAN):
                out = train.step(trainer, state, batch, seed)
        else:
            out = train.step(trainer, state, batch, seed)
        train.sync(dev)
        if pending is not None:
            float(pending.loss)
        pending = out
        steps += 1
        if steps % STOP_EVERY:
            continue
        if rank0:
            flag[0] = int(time.perf_counter() - t0 >= seconds)
        dist.broadcast(flag, 0, group=stop)
        if flag[0]:
            break
    float(pending.loss)
    train.sync(dev)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        counter.close()
    return steps, wall, prof, counter


@contextlib.contextmanager
def _planted(fault):
    """This rank's program with one exchange between the ranks taken out
    (``PROGRAM_FAULTS``), as it is for ``None``."""
    if fault is None:
        yield
        return
    if fault == "no_grad_allreduce":
        from vnet_tpu_torch.parallel.mesh import Mesh
        owner, name, value = (Mesh, "average_gradients",
                              lambda self, params: None)
    elif fault == "no_moments_allreduce":
        from vnet_tpu_torch.models import layers
        owner, name, value = layers, "moments_group", lambda: None
    else:
        raise ValueError(f"no such fault of the program: {fault!r}")
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _rank(job_dir: str) -> None:
    """One rank of a run, or of the readings of the program under each of
    ``job["faults"]`` (``job.pt`` in ``job_dir``); writes ``rank<r>.pt``."""
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    cell, seed = job["cell"], job["seed"]
    rank = dist.get_rank()
    stop = dist.new_group(backend="gloo")
    dev = _device(job["device"])
    n = int(cell.traffic["checked_steps"])
    seeds = [train.dropout_seed(seed, i) for i in range(n)]
    progs = {}
    for fault in job["faults"]:
        if progs:  # the previous reading's program first
            trainer = state = batches = None
            train.release()
        with _planted(fault):
            trainer, _ = train.build(cell, seed, dev)
            state = trainer.init_state()
            lo, hi = trainer.rows
            batches = [{k: v[lo:hi] for k, v in b.items()}
                       for b in train.pool(cell, seed, dev)]
            progs[fault] = train.checked_steps(trainer, state, batches[:n],
                                               seeds, dev)
            train.sync(dev)
    out = {}
    if job["seconds"] is not None:
        setup_s = time.perf_counter() - job["clock0"]
        stream = (train.dropout_seed(seed, i) for i in range(n, 1 << 62))
        rotated = batches[n:] + batches[:n]
        steps, wall, prof, counter = _window(trainer, state, rotated, stream,
                                             job["seconds"], job["trace"],
                                             dev, stop)
        out.update(setup_s=setup_s, steps=steps, wall=wall)
        if prof is not None:
            s = cell.settings
            per_voxel = cell.reference().flops_per_voxel(s["network"])
            work = {"flops": steps * flops.train_step(per_voxel, hi - lo,
                                                      s["patch"]),
                    "dropout_bytes": counter.bytes,
                    "dropout_launches": counter.launches}
            out["reading"] = train.traced(prof, wall, steps, work)
    out["peak"] = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    if rank == 0:
        out["progs"] = progs
    torch.save(out, os.path.join(job_dir, f"rank{rank}.pt"))


def _launch(cell, seed: int, device: str, seconds=None, trace=False,
            clock0=0.0, faults=(None,)) -> list:
    """Every rank's result file, in rank order."""
    from vnet_tpu_torch.parallel.mesh import launch

    ranks = int(cell.traffic["ranks"])
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as job_dir:
        torch.save({"cell": cell, "seed": int(seed), "device": device,
                    "seconds": seconds, "trace": trace, "clock0": clock0,
                    "faults": list(faults)},
                   os.path.join(job_dir, "job.pt"))
        launch(_rank, ranks, backend="nccl" if cuda else "gloo",
               device=device, args=(job_dir,))
        return [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(ranks)]


def _reference(cell, seed: int, device, steps: int, fault=None):
    """The reference's first ``steps`` steps on the whole global batches,
    and the weights they started from."""
    s = cell.settings
    ref = cell.reference()
    weights = data.make_weights(ref.named_shapes(s["network"]), seed, device)
    batches = train.pool(cell, seed, device)[:steps]
    seeds = [train.dropout_seed(seed, i) for i in range(steps)]
    ref.strict_float32()
    out = ref.train(weights, s, batches, seeds, ref.forward_loss(s),
                    precision="fp8" if fault == "control" else "float32",
                    steps=steps, half_batch=fault == "half_batch")
    return out, weights


def run(cell, seed: int, seconds: float, trace: bool, clock0: float,
        device="cuda") -> Outcome:
    cell = dp_cell(cell)
    s = cell.settings
    n = int(cell.traffic["checked_steps"])
    results = _launch(cell, seed, device, seconds, trace, clock0)
    r0 = results[0]
    out = Outcome(attempted=r0["steps"], failed=0, window_s=r0["wall"])
    out.memory_peak_bytes = max(r["peak"] for r in results)
    out.metrics = {"train_patches_per_s": r0["steps"] * s["batch"]
                   / r0["wall"],
                   "setup_s": r0["setup_s"],
                   "peak_mem_gib": out.memory_peak_bytes / 2 ** 30}
    out.reading = r0.get("reading")
    train.release()
    t_check = time.perf_counter()
    ref_out, weights = _reference(cell, seed, torch.device(device), n)
    out.numbers = compare.train_numbers(r0["progs"][None], ref_out, weights)
    out.check_s = time.perf_counter() - t_check
    return out


def readings(cell, seed: int, device="cuda", faults=()):
    """The check's numbers of one seed without a window, as
    ``runners/train.py::readings`` gives them: ``{"program": numbers,
    <fault>: numbers}`` (``control``: the reference in fp8 in the
    program's place; ``half_batch``: the reference on half of each global
    batch; ``PROGRAM_FAULTS``: the program without one exchange)."""
    cell = dp_cell(cell)
    n = int(cell.traffic["checked_steps"])
    progs = _launch(cell, seed, device, faults=(None,) + tuple(
        f for f in faults if f in PROGRAM_FAULTS))[0]["progs"]
    train.release()
    base, weights = _reference(cell, seed, torch.device(device), n)
    base["params"] = {k: v.cpu() for k, v in base["params"].items()}
    out = {"program": compare.train_numbers(progs.pop(None), base, weights)}
    for fault, prog in progs.items():
        out[fault] = compare.train_numbers(prog, base, weights)
    for fault in faults:
        if fault in PROGRAM_FAULTS:
            continue
        other, _ = _reference(cell, seed, torch.device(device), n, fault)
        out[fault] = compare.train_numbers(other, base, weights)
        del other
        train.release()
    return out
