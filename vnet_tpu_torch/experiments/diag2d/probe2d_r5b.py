"""2D quality probe: the same batch through the evaluation forward and a
train-mode forward, argmax Dice and loss of each.

    python -m vnet_tpu_torch.experiments.diag2d.probe2d_r5b \
        [--workdir tmp/quality2d] [--device cuda|cpu]

The port's counterpart of ``scripts/experiments/diag2d/probe2d_r5b.py``
(which hard-codes ``tmp/quality2d``): the first 32 training-pipeline
slices of the inventory go through ``models.eval_apply`` on the workdir's
``Evaluator`` network, then through a train-mode forward (batch
statistics of the batch, dropout), and each line gives the per-class
argmax Dice and the config's loss (``ops/losses.py``'s
``segmentation_loss``, weighted Sørensen in the quickstart's recipe).
Both bad with a low training loss points at a loss/Dice divergence; a good
train-mode line and a bad evaluation line at a train/evaluation forward
mismatch.

The train-mode forward is the training network's: built from the config
(its ``Dropout`` rate and ``DropoutImpl``) with the restored weights, run
with dropout seed 0 (the JAX script's ``PRNGKey(0)``), no gradient. Its
running averages are put back afterwards, as the JAX script throws away
the mutated ``batch_stats`` (torch's train mode updates them in place).
The JAX script runs its train-mode forward on the evaluator's network,
which is built with dropout 0, so its "train-mode" line has no dropout;
this one has the training's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...models import build_network, eval_apply
from ...ops.losses import segmentation_loss
from . import dice3, restore, samples, train_dataset


def train_network(cfg, device) -> torch.nn.Module:
    """The network the config trains (its dropout rate and flavour), on
    ``device``, as ``Trainer`` builds it, without weights."""
    t, n = cfg.train, cfg.train.network
    return build_network(
        n.name, num_classes=t.num_classes,
        in_channels=t.input_channels, dropout_rate=n.dropout,
        num_channels=n.num_channel, num_levels=n.num_levels,
        num_convolutions=n.num_convolutions,
        bottom_convolutions=n.bottom_convolutions, norm=n.norm,
        packed_target_lanes=n.packed_target_lanes,
        dropout_impl=n.dropout_impl, dw_impl=n.dw_impl,
        legacy_double_norm=n.name == "VNetLegacy",
        dtype=(torch.bfloat16 if t.precision == "bfloat16"
               else torch.float32),
        device=device, spatial_rank=t.dimension, patch_shape=t.patch_shape)


def train_mode_forward(network, x: torch.Tensor, dropout_seed: int = 0):
    """Logits of a train-mode forward (batch statistics, dropout keyed by
    ``dropout_seed``), no gradient; the network's buffers (the running
    averages) are exactly what they were before, and it is left in eval
    mode."""
    saved = [b.clone() for b in network.buffers()]
    network.train()
    try:
        with torch.no_grad():
            out = network(x, dropout_seed=dropout_seed)
    finally:
        with torch.no_grad():
            for b, old in zip(network.buffers(), saved):
                b.copy_(old)
        network.eval()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="tmp/quality2d",
                    help="a trained 2D workdir holding config.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg, ev = restore(args.workdir, args.device)
    ds = train_dataset(cfg)
    imgs, lbls = samples(ds, range(32))
    x = torch.from_numpy(np.stack(imgs)).to(ev.device)
    y_np = np.stack(lbls)
    y = torch.from_numpy(y_np).to(ev.device)

    def report(tag, logits):
        logits = logits.float()
        d = dice3(logits.argmax(-1).cpu().numpy(), y_np)
        loss, _ = segmentation_loss(
            logits, y, name=cfg.train.loss.name,
            num_classes=cfg.train.num_classes,
            weights=cfg.train.loss.weights)
        print(f"{tag}: argmax dice {d} loss {float(loss):.4f}", flush=True)

    report("eval_apply (train=False)", eval_apply(ev.network, x))
    net = train_network(cfg, ev.device)
    net.load_state_dict(ev.network.state_dict())
    report("train-mode (train=True) ", train_mode_forward(net, x, 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
