"""Dry run of the multi-rank paths — counterpart of ``__graft_entry__.py``'s
``dryrun_multichip`` (``_dryrun_impl``).

    python -m vnet_tpu_torch.tools.dryrun_multichip [--ranks N]
        [--device cpu|cuda] [--backend gloo|nccl]

Spawns ``N`` ranks (``parallel.launch``; one ``nccl`` rank a card by
default, ``gloo`` ranks on the CPU with ``--device cpu``) and takes one
real step of each path at tiny shapes, each held to its unsharded
counterpart computed on the rank itself:

1. the data-parallel training step (``train/trainer.py::make_train_step``
   over a data axis of ``N`` ranks): a finite loss, the same parameters on
   every rank;
2. the halo-exchange convolution (``parallel/halo.py::sharded_conv``), the
   whole-network halo-sharded forward and one spatially partitioned SGD
   step (``parallel/spatial.py``) over a space axis of ``N`` ranks;
3. the column-parallel convolution (``parallel/tensor.py::tp_conv``);
4. the sliding window with its grid sharded over the ranks, 3D and
   slice-stacked 2D.

Prints one JSON line of the readings; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# float32 sums in other orders (halos, shards, all-gathers); on a card
# with TF32 off, as the dry run sets it, since TF32 rounds the operands
ATOL = 1e-4


def _net(**kw):
    from ..models import build_network

    args = dict(num_classes=2, dropout_rate=0.0, num_channels=4,
                num_levels=2, num_convolutions=(1, 1), bottom_convolutions=1,
                norm="batch", generator=torch.Generator().manual_seed(0))
    args.update(kw)
    return build_network("VNet", **args)


def dryrun_rank(device) -> dict:
    """Every path once on this rank of the running process group; returns
    the readings and the failed checks."""
    from ..config import LossConfig, OptimizerConfig
    from ..infer.sliding_window import SlidingWindowInference
    from ..models import eval_apply
    from ..ops.losses import segmentation_loss
    from ..parallel import make_mesh
    from ..parallel.halo import shard_volume, sharded_conv
    from ..parallel.spatial import (spatial_sharded_forward,
                                    spatial_sharded_train_step)
    from ..parallel.tensor import make_tp_mesh, tp_conv
    from ..train.optim import build_optimizer
    from ..train.trainer import TrainState, make_train_step

    world = dist.get_world_size()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data_mesh = make_mesh(device=device)
    space_mesh = make_mesh(data_parallel=1, space_parallel=world,
                           device=device)
    dev = data_mesh.device
    out, failed = {}, []

    # (1) the data-parallel training step
    net = _net(dropout_rate=0.01, device=dev)
    opt, schedule = build_optimizer(OptimizerConfig(
        name="Adam", initial_learning_rate=1e-3), net.parameters())
    step = make_train_step(LossConfig(name="mixed_weighted_sorensen",
                                      weights=(0.1, 1.0), alpha=0.5), 2,
                           schedule, mesh=data_mesh)
    rng = np.random.default_rng(world)
    images = rng.normal(size=(world, 16, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (world, 16, 16, 16)).astype(np.int64)
    r = data_mesh.rank
    res = step(TrainState(net, opt), torch.from_numpy(images[r:r + 1]).to(
        dev), torch.from_numpy(labels[r:r + 1]).to(dev), 7)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    first = flat.clone()
    dist.broadcast(first, 0)
    out["dp_loss"] = float(res.loss)
    if not (np.isfinite(out["dp_loss"]) and torch.equal(flat, first)):
        failed.append("data-parallel step: loss or parameters")

    # (2) halo-exchange convolution, forward, partitioned step
    vol = rng.normal(size=(4 * world, 8, 8, 2)).astype(np.float32)
    kern = torch.from_numpy(rng.normal(size=(2, 2, 3, 3, 3)).astype(
        np.float32) * 0.1).to(dev)
    got = sharded_conv(space_mesh, 0)(shard_volume(space_mesh, 0, vol), kern)
    ref = F.conv3d(torch.from_numpy(vol).to(dev).movedim(-1, 0)[None], kern,
                   padding=1)[0].movedim(0, -1)
    s0, s1 = space_mesh.slab(vol.shape[0])
    out["halo_conv_err"] = float((got - ref[s0:s1]).abs().max())

    net = _net(conv_impl="packed", packed_target_lanes=128, device=dev)
    vol = rng.normal(size=(8 * world, 8, 8, 1)).astype(np.float32)
    got = spatial_sharded_forward(net, vol, space_mesh)
    ref = eval_apply(net, torch.from_numpy(vol).to(dev)[None])[0]
    out["forward_err"] = float((got - ref).abs().max())

    net, twin = _net(device=dev), _net(device=dev)
    imgs = rng.normal(size=(1, 8 * world, 8, 8, 1)).astype(np.float32)
    lbls = rng.integers(0, 2, (1, 8 * world, 8, 8)).astype(np.int64)
    sp_step = spatial_sharded_train_step(net, space_mesh,
                                         loss_name="sorensen", num_classes=2)
    _, sp_loss = sp_step((net, torch.optim.SGD(net.parameters(), 1e-2)),
                         imgs, lbls, 5)
    twin.train()
    ref_loss, _ = segmentation_loss(
        twin(torch.from_numpy(imgs).to(dev)),
        torch.from_numpy(lbls).to(dev), name="sorensen", num_classes=2)
    out["train_loss_err"] = abs(sp_loss - float(ref_loss.detach()))

    # (3) column-parallel convolution
    tp_mesh = make_tp_mesh(world, device=device)
    xt = torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 4)).astype(
        np.float32)).to(dev)
    kt = torch.from_numpy(rng.normal(size=(2 * world, 4, 3, 3, 3)).astype(
        np.float32) * 0.1).to(dev)
    got = tp_conv(tp_mesh, xt, kt)
    ref = F.conv3d(xt.movedim(-1, 1), kt, padding=1).movedim(1, -1)
    out["tp_conv_err"] = float((got - ref).abs().max())

    for key in ("halo_conv_err", "forward_err", "train_loss_err",
                "tp_conv_err"):
        if not out[key] <= ATOL:
            failed.append(f"{key} {out[key]:.3g} > {ATOL:g}")

    # (4) the sharded sliding window, 3D and slice-stacked 2D
    def apply(patches):
        v = patches[..., 0]
        return torch.stack([torch.zeros_like(v), v], dim=-1)

    eng = SlidingWindowInference(apply, (4, 4, 4), (2, 2, 2), 2, 2,
                                 device=dev, mesh=data_mesh)
    _, w = eng(np.zeros((8, 8, 8, 1), np.float32))
    eng2 = SlidingWindowInference(apply, (4, 4), (2, 2), 2, 2, device=dev,
                                  mesh=data_mesh, slice_stacked=True)
    _, w2 = eng2(np.zeros((3, 8, 8, 1), np.float32))
    out["window_min_weight"] = [float(w.min()), float(w2.min())]
    if min(out["window_min_weight"]) < 1.0 or tuple(w2.shape) != (3, 8, 8):
        failed.append("sharded sliding window: uncovered voxels")
    return {"rank": data_mesh.rank, "world": world, "readings": out,
            "failed": failed}


def _rank(out_dir: str, device: str) -> None:
    result = dryrun_rank(device)
    torch.save(result, os.path.join(out_dir, f"rank{result['rank']}.pt"))


def main(argv=None) -> dict:
    from ..parallel import launch

    p = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.tools.dryrun_multichip")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on card r) or cpu (gloo ranks)")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    if args.ranks < 2:
        raise SystemExit("the dry run needs at least 2 ranks")
    with tempfile.TemporaryDirectory() as tmp:
        launch(_rank, args.ranks, backend=args.backend, device=args.device,
               init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
               args=(tmp, args.device), timeout=600)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(args.ranks)]
    failed = [f"rank {r['rank']}: {f}" for r in ranks for f in r["failed"]]
    summary = {"dryrun_multichip": {"ranks": args.ranks,
                                    "device": args.device,
                                    "readings": ranks[0]["readings"],
                                    "failed": failed}}
    print(json.dumps(summary), flush=True)
    if failed:
        raise SystemExit("dryrun_multichip: " + "; ".join(failed))
    return summary


if __name__ == "__main__":
    main()
