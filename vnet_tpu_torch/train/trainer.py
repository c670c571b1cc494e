"""Training orchestrator of the port: the train step, the epoch loop,
checkpoints and scalar logs — counterpart of ``vnet_tpu/train/trainer.py``.

One device, eager PyTorch: the step is forward (``VNet`` in train mode,
dropout keyed by the step's seed), loss, ``backward``, optimizer step, in
place on the network and optimizer that :class:`TrainState` holds. The loop
keeps the JAX trainer's semantics: a checkpoint every ``LogInterval`` steps
and at the end of every ``CheckpointEveryNEpochs``-th epoch, the epoch
counter inside the checkpoint so a resumed run continues it, ``Restore:
false`` wipes the log and checkpoint directories, ``MaxIterations`` stops
training (with a checkpoint), an optional test batch every ``TestStep``
steps, and a training set that yields no batch is an error. ``ScanSteps``
K > 1 runs K steps back to back on K buffered batches (the JAX package's
``lax.scan`` block), timed as one block.

Scalars go to ``LogDir/<tag>/scalars.jsonl`` (one JSON object per value:
``tag``, ``step``, ``value``) under the JAX trainer's TensorBoard tags.
``DeviceAugment``, attention networks, ``ImageLog``, 2D patches and
multi-device meshes raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config, load_pipeline
from ..data import BatchLoader, NiftiDataset3D, build_pipeline
from ..device import resolve_device
from ..models import build_network
from ..ops.losses import segmentation_loss
from ..ops.metrics import batch_metrics
from ..profiler import StepTimer
from . import checkpoints
from .optim import build_optimizer, set_learning_rate


@dataclass
class TrainState:
    """The network and optimizer trained in place, and the counters."""

    network: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0


@dataclass
class TrainStepOutput:
    loss: torch.Tensor
    aux: Dict[str, torch.Tensor]
    metrics: Dict[str, torch.Tensor]


def make_train_step(loss_cfg, num_classes: int,
                    schedule: Callable[[int], float],
                    compute_metrics: bool = True, compute_auc: bool = False):
    """The train step ``(state, images, labels, dropout_seed) ->
    TrainStepOutput``: images ``(B, x, y, z, C)`` float and labels
    ``(B, x, y, z)`` int on the network's device. Updates ``state`` in
    place (parameters, running averages, optimizer state, ``step``); the
    gradients stay in the parameters' ``.grad``. Returned values stay on the
    device."""

    def step_fn(state: TrainState, images, labels, dropout_seed: int):
        net, opt = state.network, state.optimizer
        net.train()
        set_learning_rate(opt, schedule, state.step)  # pre-increment count
        opt.zero_grad(set_to_none=True)
        logits = net(images, dropout_seed=dropout_seed)
        loss, aux = segmentation_loss(
            logits, labels, name=loss_cfg.name, num_classes=num_classes,
            weights=loss_cfg.weights, alpha=loss_cfg.alpha)
        loss.backward()
        opt.step()
        state.step += 1
        logits = logits.detach()
        metrics = (batch_metrics(logits, labels, num_classes,
                                 compute_auc=compute_auc)
                   if compute_metrics else {})
        return TrainStepOutput(loss.detach(),
                               {k: v.detach() for k, v in aux.items()},
                               metrics)

    return step_fn


def make_eval_step(loss_cfg, num_classes: int, compute_auc: bool = False):
    """Loss and metrics of a test batch, updating nothing."""

    def step_fn(state: TrainState, images, labels):
        net = state.network
        net.eval()
        with torch.inference_mode():
            logits = net(images)
            loss, aux = segmentation_loss(
                logits, labels, name=loss_cfg.name, num_classes=num_classes,
                weights=loss_cfg.weights, alpha=loss_cfg.alpha)
            metrics = batch_metrics(logits, labels, num_classes,
                                    compute_auc=compute_auc)
        return TrainStepOutput(loss, aux, metrics)

    return step_fn


class ScalarLog:
    """Append-only ``scalars.jsonl`` of one tag directory."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self._file = open(os.path.join(directory, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "step": int(step),
                                     "value": float(value)}) + "\n")

    def close(self) -> None:
        self._file.close()


class Trainer:
    """End-to-end training, configured like the JAX trainer."""

    def __init__(self, config: Config, device="cuda", log: bool = True):
        self.config = config
        self.t = t = config.train
        self.device = resolve_device(device)
        self.log_enabled = log
        net_cfg = t.network
        if t.dimension != 3:
            raise NotImplementedError("2D training is not ported yet "
                                      "(ROADMAP.md)")
        if net_cfg.attention:
            raise NotImplementedError("AttentionVNet is not ported yet "
                                      "(ROADMAP.md)")
        if t.device_augment:
            raise NotImplementedError("DeviceAugment is not ported yet "
                                      "(ROADMAP.md)")
        if t.image_log:
            raise NotImplementedError("ImageLog is not ported yet "
                                      "(ROADMAP.md)")
        if t.mesh_space_parallel > 1 or t.mesh_dcn_parallel > 1:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet (ROADMAP.md)")
        self.dtype = (torch.bfloat16 if t.precision == "bfloat16"
                      else torch.float32)
        self.network = build_network(
            net_cfg.name, num_classes=t.num_classes,
            in_channels=t.input_channels, dropout_rate=net_cfg.dropout,
            num_channels=net_cfg.num_channel, num_levels=net_cfg.num_levels,
            num_convolutions=net_cfg.num_convolutions,
            bottom_convolutions=net_cfg.bottom_convolutions,
            norm=net_cfg.norm, dtype=self.dtype, device=self.device,
            generator=torch.Generator().manual_seed(t.seed),
            dropout_impl=net_cfg.dropout_impl, dw_impl=net_cfg.dw_impl)
        self.optimizer, self.lr_schedule = build_optimizer(
            t.optimizer, self.network.parameters())
        self._train_step_fn = make_train_step(
            t.loss, t.num_classes, self.lr_schedule,
            compute_auc=t.compute_auc)
        self._eval_step_fn = make_eval_step(t.loss, t.num_classes,
                                            compute_auc=t.compute_auc)
        self._writers = {}

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        return TrainState(self.network, self.optimizer)

    def _to_device(self, images, labels):
        images = torch.from_numpy(np.asarray(images, np.float32))
        labels = torch.from_numpy(np.asarray(labels, np.int32))
        return (images.to(self.device, non_blocking=True),
                labels.to(self.device, non_blocking=True))

    def train_step(self, state: TrainState, images, labels,
                   dropout_seed: int) -> TrainStepOutput:
        return self._train_step_fn(state, *self._to_device(images, labels),
                                   dropout_seed)

    def eval_step(self, state: TrainState, images, labels) -> TrainStepOutput:
        return self._eval_step_fn(state, *self._to_device(images, labels))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def build_loader(self, data_dir: str, phase: str) -> BatchLoader:
        t = self.t
        transforms = build_pipeline(load_pipeline(t.pipeline_path), phase, 3)
        ds = NiftiDataset3D(
            data_dir, t.image_filenames, t.label_filename,
            transforms=transforms, train=True,
            labels=t.segmentation_classes, cache_cases=t.cache_cases)
        return BatchLoader(ds, t.batch_size, shuffle=True,
                           drop_remainder=True, num_workers=t.loader_workers,
                           backend=t.loader_backend, seed=t.seed)

    # ------------------------------------------------------------------
    def _writer(self, tag: str) -> Optional[ScalarLog]:
        if not self.log_enabled:
            return None
        if tag not in self._writers:
            self._writers[tag] = ScalarLog(os.path.join(self.t.log_dir, tag))
        return self._writers[tag]

    def _log_scalars(self, tag: str, step: int, out: TrainStepOutput) -> float:
        """Write the step's scalars (reading them from the device) and
        return the loss as a float."""
        loss = float(out.loss)
        w = self._writer(tag)
        if w is None:
            return loss
        class_ids = self.t.segmentation_classes
        w.add_scalar("loss/0.total_loss", loss, step)
        for k, v in out.aux.items():
            if k != "total_loss":
                w.add_scalar(f"loss/{k}", float(v), step)
        w.add_scalar("learning_rate", self.lr_schedule(step), step)
        for k, v in out.metrics.items():
            if "_" in k and k.rsplit("_", 1)[-1].isdigit():
                base, idx = k.rsplit("_", 1)
                k = f"{base}_{class_ids[int(idx)]}"  # index -> class id
            w.add_scalar(f"metrics/{k}", float(v), step)
        return loss

    def _save(self, state: TrainState) -> None:
        checkpoints.save(self.t.ckpt_dir, state.network.state_dict(),
                         state.step, state.optimizer.state_dict(),
                         state.epoch)

    # ------------------------------------------------------------------
    def train(self, max_steps: Optional[int] = None) -> TrainState:
        t = self.t
        if not t.restore:
            for d in (t.log_dir, t.ckpt_dir):
                if os.path.exists(d):
                    shutil.rmtree(d)
                os.makedirs(d, exist_ok=True)
        state = self.init_state()
        if t.restore:
            saved = checkpoints.restore_latest_state(t.ckpt_dir)
            if saved is not None:
                state.network.load_state_dict(saved["model"])
                state.optimizer.load_state_dict(saved["optimizer"])
                state.step, state.epoch = saved["step"], saved["epoch"]
                print(f"Restored checkpoint at step {state.step}, "
                      f"epoch {state.epoch}")
        try:
            return self._train_loop(state, max_steps)
        finally:
            for w in self._writers.values():
                w.close()
            self._writers = {}

    def _dropout_seeds(self, start_step: int):
        """Per-step dropout seeds from a generator seeded with ``Seed + 1``;
        a resumed run skips the seeds of the steps already taken."""
        gen = torch.Generator().manual_seed(self.t.seed + 1)
        step = 0
        while True:
            seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen,
                                     dtype=torch.int64))
            if step >= start_step:
                yield seed
            step += 1

    def _train_loop(self, state: TrainState, max_steps):
        t = self.t
        train_loader = self.build_loader(t.data_dir, "train")
        test_loader = (self.build_loader(t.test_data_dir, "test")
                       if t.testing and t.test_data_dir else None)
        test_iter = (iter(()) if test_loader is None
                     else iter(test_loader.epoch()))
        seeds = self._dropout_seeds(state.step)
        timer = StepTimer(warmup=2)
        limit = t.max_iterations if max_steps is None else max_steps
        scan_k = max(1, t.scan_steps)
        scan_buf = []  # carries across epochs, as the JAX trainer's
        for epoch in range(state.epoch, t.epochs):
            epoch_loss, count = 0.0, 0
            t0 = time.time()
            pending = None  # (step, out), logged one step late
            epoch_batches = 0
            for images, labels, *_ in train_loader.epoch():
                epoch_batches += 1
                if state.step >= limit:
                    print("Reach maximum iteration steps, training abort.")
                    self._save(state)
                    return state
                scan_buf.append((images, labels))
                if len(scan_buf) < scan_k:
                    continue
                with timer:
                    outs = [self.train_step(state, im, lb, next(seeds))
                            for im, lb in scan_buf]
                    self._sync()
                scan_buf = []
                for i, out in enumerate(outs):
                    if pending is not None:
                        epoch_loss += self._log_scalars("train", *pending)
                        count += 1
                    pending = (state.step - len(outs) + 1 + i, out)
                w = self._writer("train")
                if w is not None and timer.times:
                    per_step = timer.times[-1] / scan_k
                    w.add_scalar("perf/step_time_s", per_step, state.step)
                    w.add_scalar("perf/patches_per_s",
                                 t.batch_size / per_step, state.step)

                if state.step % t.log_interval == 0:
                    self._save(state)

                if test_loader is not None and state.step % t.test_step == 0:
                    test_batch = next(test_iter, None)
                    if test_batch is None:
                        test_iter = iter(test_loader.epoch())
                        test_batch = next(test_iter, None)
                    if test_batch is None:
                        print("Testing enabled but the test dataset yields "
                              "no batches (fewer cases than BatchSize?); "
                              "disabling inline testing.")
                        test_loader = None
                    else:
                        timages, tlabels, *_ = test_batch
                        self._log_scalars("test", state.step, self.eval_step(
                            state, timages, tlabels))

            if epoch_batches == 0:
                raise ValueError(
                    "Training dataset yields no batches: fewer cases than "
                    f"BatchSize={t.batch_size} with drop_remainder (the "
                    "reference's tf.data semantics). Lower BatchSize or add "
                    "training cases.")
            if pending is not None:
                epoch_loss += self._log_scalars("train", *pending)
                count += 1
            if count:
                print(f"Epoch {epoch + 1}: loss {epoch_loss / count:.4f} "
                      f"({count} steps, {time.time() - t0:.1f}s)")
            state.epoch += 1
            n_ck = max(1, t.ckpt_every_n_epochs)
            if (epoch + 1) % n_ck == 0 or epoch + 1 == t.epochs:
                self._save(state)
        return state
