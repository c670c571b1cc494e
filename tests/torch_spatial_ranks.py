"""Rank functions of ``tests/test_torch_spatial.py``: each runs on every
rank of a four-rank ``gloo`` group on the CPU (``parallel.launch``) and
writes its results to ``<workdir>/rank<r>.pt``.

This module imports torch and the port only, so the spawned ranks import
no JAX. The parent test prepares the inputs (``inputs.pt``) and holds the
results against JAX and against the port's own single process.
"""

import os

import numpy as np
import torch

from vnet_tpu_torch.config import load_config
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.models.layers import Dropout
from vnet_tpu_torch.parallel import make_mesh
from vnet_tpu_torch.parallel.halo import (halo_exchange, shard_volume,
                                          sharded_conv)
from vnet_tpu_torch.parallel.spatial import (mesh_partition,
                                             spatial_sharded_forward,
                                             spatial_sharded_train_step)
from vnet_tpu_torch.parallel.tensor import make_tp_mesh, tp_conv
from vnet_tpu_torch.tools.dryrun_multichip import dryrun_rank
from vnet_tpu_torch.train import Trainer


def build(net_kw, state_dict):
    net = build_network("VNet", device="cpu", **net_kw)
    net.load_state_dict(state_dict)
    return net


def halo_run(mesh, vol, weight, cot_halo, cot_conv):
    """The rank's halo'd slab and sharded convolution of ``vol`` (JAX
    layout ``(*spatial, C)``), and the input gradients of ``sum(out *
    cot)`` for each, ``cot`` the rank's part of the global cotangent
    (``shard_map``'s concatenated outputs for the halo'd slabs)."""
    part = mesh_partition(mesh, 0)
    h = weight.shape[2] // 2
    m = vol.shape[0] // mesh.space + 2 * h
    s = mesh.space_index
    cot_halo = cot_halo[s * m:(s + 1) * m]
    s0, s1 = mesh.slab(vol.shape[0])
    cot_conv = cot_conv[s0:s1]
    x = shard_volume(mesh, 0, vol).requires_grad_()
    out = halo_exchange(x.movedim(-1, 0)[None], h, part, 0)[0].movedim(0, -1)
    (out * torch.from_numpy(cot_halo)).sum().backward()
    res = {"halo": out.detach().numpy(), "halo_dx": x.grad.numpy()}
    x = shard_volume(mesh, 0, vol).requires_grad_()
    y = sharded_conv(mesh, 0)(x, torch.from_numpy(weight))
    (y * torch.from_numpy(cot_conv)).sum().backward()
    res.update(conv=y.detach().numpy(), conv_dx=x.grad.numpy())
    return res


def train_run(mesh, case):
    """Two SGD steps of ``spatial_sharded_train_step``: losses and the
    state dict."""
    net = build(case["net_kw"], case["state_dict"])
    opt = torch.optim.SGD(net.parameters(), lr=case["lr"])
    step = spatial_sharded_train_step(
        net, mesh, loss_name=case["loss"], num_classes=case["classes"],
        weights=case["weights"], spatial_axis=case["axis"])
    losses = []
    carry = (net, opt)
    for i in range(2):
        carry, loss = step(carry, case["images"], case["labels"], i)
        losses.append(loss)
    return {"losses": losses,
            "state_dict": {k: v.clone() for k, v in net.state_dict().items()}}


def dropout_masks(net):
    """Forward hooks recording each dropout call's ``(dropped, valid,
    layer index)``, the two bool arrays in the logical ``(B, C, *spatial)``
    layout (a recomputed layer's calls follow the forward's)."""
    records = []

    def hook(module, inputs, out):
        x = inputs[0]
        records.append((((out == 0) & (x != 0)).numpy(), (x != 0).numpy(),
                        module.index))

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, Dropout)]
    return records, handles


def trainer_steps(config_path, state_dict, images, labels, seeds,
                  device_augment=None, masks=False):
    """``Trainer.train_step`` for each seed on this rank's rows (whole
    patches; the trainer keeps its slab), from ``state_dict`` (``None``:
    the trainer's own initial weights): logged values, the state dict
    after the steps, the last step's gradients and, with ``masks``, every
    dropout layer's mask of the last step."""
    trainer = Trainer(load_config(config_path), device="cpu", log=False)
    if state_dict is not None:  # else the trainer's seeded weights
        trainer.network.load_state_dict(state_dict)
    trainer._device_aug = device_augment
    state = trainer.init_state()
    lo, hi = trainer.rows
    records, handles = dropout_masks(trainer.network) if masks else ([], [])
    outs = []
    for seed in seeds:
        del records[:]
        outs.append(trainer.train_step(state, images[lo:hi], labels[lo:hi],
                                       seed))
    for h in handles:
        h.remove()
    out = outs[-1]
    return {"losses": [float(o.loss) for o in outs],
            "metrics": {k: float(v) for k, v in out.metrics.items()},
            "state_dict": {k: v.detach().clone()
                           for k, v in state.network.state_dict().items()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.network.named_parameters()},
            "masks": records, "mesh": (trainer.mesh.data_index,
                                       trainer.mesh.space_index)}


def trained(config_path, state_dict):
    """``Trainer.train`` from ``state_dict`` (a checkpoint-free start): the
    state dict at its end."""
    trainer = Trainer(load_config(config_path), device="cpu", log=False)
    trainer.network.load_state_dict(state_dict)
    state = trainer.train()
    return {k: v.clone() for k, v in state.network.state_dict().items()}


def host_draws(config_path):
    """``Trainer.train`` with every batch the rank's loader hands its row
    recorded (whole patches, before the rank keeps its slab)."""
    trainer = Trainer(load_config(config_path), device="cpu", log=False)
    seen, row_batch = [], trainer._row_batch

    def recorded(batch):
        seen.append(torch.as_tensor(batch[0]).clone())
        return row_batch(batch)

    trainer._row_batch = recorded
    trainer.train()
    return seen


def spatial_ranks(workdir):
    """Every four-rank computation of the tests, on this rank."""
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    s4 = make_mesh(data_parallel=1, space_parallel=4, device="cpu")
    s2 = make_mesh(data_parallel=2, space_parallel=2, device="cpu")
    out = {"rank": s4.rank, "grid": (s2.data_index, s2.space_index),
           "space_ranks": s2.space_ranks}
    out["halo"] = {name: halo_run(s4, *args)
                   for name, args in inp["halo"].items()}
    out["forward"] = {}
    for name, case in inp["forward"].items():
        net = build(case["net_kw"], case["state_dict"])
        y = spatial_sharded_forward(net, case["volume"], s4, case["axis"])
        out["forward"][name] = y.numpy()
    out["train"] = {name: train_run(s4 if case["shards"] == 4 else s2, case)
                    for name, case in inp["train"].items()}
    step = inp["trainer"]
    out["trainer"] = trainer_steps(step["config"], step["state_dict"],
                                   step["images"], step["labels"], (0, 1))
    aug = inp["augmented"]
    out["augmented"] = trainer_steps(aug["config"], aug["state_dict"],
                                     aug["images"], aug["labels"], (3,),
                                     aug["device_augment"], masks=True)
    out["remat"] = {r: trainer_steps(
        path, None, aug["images"], aug["labels"], (3,),
        aug["device_augment"], masks=True)
        for r, path in aug["remat"].items()}
    scan = inp["scan"]
    out["scan"] = trained(scan["config"], scan["state_dict"])
    out["draws"] = host_draws(inp["draws"])
    tp = make_tp_mesh(device="cpu")
    out["tp"] = {name: tp_conv(tp, torch.from_numpy(x), torch.from_numpy(w)
                               ).numpy()
                 for name, (x, w) in inp["tp"].items()}
    out["dryrun"] = dryrun_rank("cpu")
    torch.save(out, os.path.join(workdir, f"rank{s4.rank}.pt"))
