"""Rank functions of ``tests/test_torch_parallel.py`` (and
``swin_step``, of ``tests/test_torch_swin_parallel.py``): each runs on every
rank of a ``gloo`` group on the CPU (``parallel.launch``) and writes its
results to ``<workdir>/rank<r>.pt``.

This module imports torch and the port only, so the spawned ranks import
no JAX. The parent test prepares the inputs (``inputs.pt``: numpy arrays,
state dicts, a config path) and holds the results against JAX and against
the port's own single-process run.
"""

import os

import numpy as np
import torch

from vnet_tpu_torch.config import load_config
from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference
from vnet_tpu_torch.models import build_network, eval_apply
from vnet_tpu_torch.models.layers import (BatchNorm, Dropout,
                                          TiledInputBatchNorm)
from vnet_tpu_torch.ops.metrics import batch_metrics
from vnet_tpu_torch.parallel import batch_rows, data_parallel, make_mesh
from vnet_tpu_torch.tools.profile_step import count_collectives
from vnet_tpu_torch.train import Trainer, checkpoints
from vnet_tpu_torch.train import trainer as trainer_module

BN_CASES = ("unpacked", "packed", "tiled")


def bn_module(case: str, channels: int, rng: np.random.Generator):
    """A training-mode batch norm of ``case`` with random affine and running
    averages from ``rng``; ``(module, forward)``."""
    mod = (TiledInputBatchNorm(channels) if case == "tiled"
           else BatchNorm(channels))
    bn = mod.bn if case == "tiled" else mod
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(size=channels)
                                     .astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, channels).astype(np.float32)))
    mod.train()
    if case == "tiled":
        return mod, mod
    groups = 2 if case == "packed" else 1
    return mod, lambda x: mod(x, False, groups)


def bn_run(case, x, cot, channels, seed, mesh=None):
    """Forward and backward of ``sum(bn(x) * cot)``: output, input
    gradient, parameter gradients and running averages (numpy)."""
    mod, fwd = bn_module(case, channels, np.random.default_rng(seed))
    x = torch.from_numpy(x).requires_grad_()
    with data_parallel(mesh):
        y = fwd(x)
        (y * torch.from_numpy(cot)).sum().backward()
    bn = mod.bn if case == "tiled" else mod
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy().copy(),
            "running_var": bn.running_var.numpy().copy()}


def dropout_run(x, seed, mesh=None):
    """A ``pallas`` dropout layer of rate 0.3 in training mode."""
    layer = Dropout(0.3, "pallas", index=5).train()
    layer.seed = seed
    with data_parallel(mesh):
        return layer(torch.from_numpy(x)).numpy()


def trainer_step(config_path, state_dict, images, labels, seed,
                 device_augment=None):
    """One ``Trainer.train_step`` on this process's rows of the global
    batch (all of it without a group): the logged values, the state dict
    after the step and the gradients the optimizer took."""
    trainer = Trainer(load_config(config_path), device="cpu", log=False)
    trainer.network.load_state_dict(state_dict)
    trainer._device_aug = device_augment
    state = trainer.init_state()
    lo, hi = trainer.rows
    out = trainer.train_step(state, images[lo:hi], labels[lo:hi], seed)
    return {"loss": float(out.loss),
            "aux": {k: float(v) for k, v in out.aux.items()},
            "metrics": {k: float(v) for k, v in out.metrics.items()},
            "state_dict": {k: v.detach().clone()
                           for k, v in state.network.state_dict().items()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.network.named_parameters()}}


def swin_step(workdir):
    """One ``Trainer.train_step`` of the small ``SwinUNETR`` in
    ``<workdir>/inputs.pt`` on this rank's rows."""
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = trainer_step(inp["config"], inp["state_dict"], inp["images"],
                       inp["labels"], 0)
    rank = torch.distributed.get_rank()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def window_run(net_kw, state_dict, volume, patch, stride, batch, classes,
               mesh=None, global_stats=False):
    """The sliding window of a small VNet over ``volume``, grid sharded
    over ``mesh``: ``(acc, weight)`` (numpy). ``global_stats`` runs it
    inside ``data_parallel(mesh)``, which the port never does: batch
    statistics then mix the ranks' batches (the tests' negative control)."""
    net = build_network("VNet", device="cpu", **net_kw)
    net.load_state_dict(state_dict)
    engine = SlidingWindowInference(
        lambda p: eval_apply(net, p), patch, stride, batch, classes,
        gaussian_blend=True, device="cpu", mesh=mesh)
    with data_parallel(mesh if global_stats else None):
        acc, weight = engine(volume)
    return acc.numpy(), weight.numpy()


def stacked_window_run(volume, weights, mesh=None):
    """The slice-stacked 2D sliding window of a per-voxel model whose
    logits depend on each batch's mean (as ``batch_stats`` does), its grid
    sharded over ``mesh``: ``(acc, weight)`` (numpy)."""
    w = torch.from_numpy(weights)
    engine = SlidingWindowInference(
        lambda p: torch.einsum("...c,ck->...k", p - p.mean(), w),
        (8, 8), (5, 6), 5, weights.shape[1], gaussian_blend=True,
        slice_stacked=True, device="cpu", mesh=mesh)
    acc, weight = engine(volume)
    return acc.numpy(), weight.numpy()


def remat_run(net_kw, state_dict, images, cot, mesh):
    """Per ``Remat`` off and on: two training-mode forwards inside
    ``data_parallel(mesh)`` (dropout seeds 1 and 2, the second on the
    images reversed along the batch), then the first forward's backward of
    ``sum(out * cot)`` outside it: the gradients, the state dict and the
    collectives called by the first forward and by the backward."""
    out = {}
    counts, restore = count_collectives()
    try:
        for remat in (False, True):
            net = build_network("VNet", device="cpu", remat=remat, **net_kw)
            net.load_state_dict(state_dict)
            net.train()
            x = torch.from_numpy(images)
            counts.clear()
            with data_parallel(mesh):
                first = (net(x, dropout_seed=1) * torch.from_numpy(cot)).sum()
                forward = dict(counts)
                net(x.flip(0), dropout_seed=2)
            counts.clear()
            first.backward()
            out[remat] = {
                "grads": {k: p.grad.clone()
                          for k, p in net.named_parameters()},
                "state_dict": {k: v.clone()
                               for k, v in net.state_dict().items()},
                "collectives": {"forward": forward,
                                "backward": dict(counts)}}
    finally:
        restore()
    return out


def _recording_writes(trainer, record):
    """Count what ``trainer`` writes: checkpoints, the sidecar and the log
    directories it opens."""
    save = checkpoints.save

    def save_spy(*args, **kwargs):
        record.append("checkpoint")
        return save(*args, **kwargs)

    class TagLogSpy(trainer_module.TagLog):
        def __init__(self, directory):
            record.append("log:" + os.path.basename(directory))
            super().__init__(directory)

    sidecar = trainer._write_network_sidecar

    def sidecar_spy(ckpt_dir):
        record.append("sidecar")
        sidecar(ckpt_dir)

    trainer._write_network_sidecar = sidecar_spy
    return save_spy, TagLogSpy


def parity_ranks(workdir):
    """Every R = 2 computation of the parity tests, on this rank."""
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world_size, "data": mesh.data}

    bn = {}
    for case in BN_CASES:
        x, cot = inp["bn"][case]
        lo, hi = batch_rows(mesh, len(x))
        bn[case] = bn_run(case, x[lo:hi], cot[lo:hi], inp["bn_channels"],
                          inp["bn_seed"], mesh)
    out["bn"] = bn

    x = inp["dropout_x"]
    lo, hi = batch_rows(mesh, len(x))
    out["dropout"] = dropout_run(x[lo:hi], inp["dropout_seed"], mesh)

    logits, labels = inp["metrics"]
    lo, hi = batch_rows(mesh, len(logits))
    out["metrics"] = {k: float(v) for k, v in batch_metrics(
        torch.from_numpy(logits[lo:hi]), torch.from_numpy(labels[lo:hi]),
        logits.shape[-1], compute_auc=True, reduce=mesh.sum).items()}

    rm = inp["remat"]
    lo, hi = batch_rows(mesh, len(rm["images"]))
    out["remat"] = remat_run(rm["net_kw"], rm["state_dict"],
                             rm["images"][lo:hi], rm["cot"][lo:hi], mesh)

    step = inp["step"]
    out["step"] = trainer_step(step["config"], step["state_dict"],
                               step["images"], step["labels"], 0)
    aug = inp["augmented"]
    out["augmented"] = trainer_step(aug["config"], aug["state_dict"],
                                    aug["images"], aug["labels"], 3,
                                    aug["device_augment"])

    win = inp["window"]
    out["window"] = {
        norm: window_run(dict(win["net_kw"], norm=norm), win["state_dicts"][
            norm], win["volume"], win["patch"], win["stride"], win["batch"],
            win["net_kw"]["num_classes"], mesh)
        for norm in ("batch", "batch_stats")}
    out["window_2d"] = stacked_window_run(inp["stack"], inp["stack_weights"],
                                          mesh)
    out["window_global_stats"] = window_run(
        dict(win["net_kw"], norm="batch_stats"),
        win["state_dicts"]["batch_stats"], win["volume"], win["patch"],
        win["stride"], win["batch"], win["net_kw"]["num_classes"], mesh,
        global_stats=True)

    record = []
    trainer = Trainer(load_config(inp["writes_config"]), device="cpu")
    save_spy, tag_log_spy = _recording_writes(trainer, record)
    checkpoints.save, trainer_module.TagLog = save_spy, tag_log_spy
    trainer.train()
    out["writes"] = record
    resumed = Trainer(load_config(inp["resume_config"]), device="cpu",
                      log=False)
    out["resumed_step"] = resumed.train().step
    torch.save(out, os.path.join(workdir, f"rank{mesh.rank}.pt"))
