"""Training orchestrator of the port: the train step, the epoch loop,
checkpoints and logs — counterpart of ``vnet_tpu/train/trainer.py``.

The network is built as the JAX trainer builds it (``build_network``'s
defaults): packed convolutions with adaptive per-level packing at
``PackedTargetLanes``, the double norm of ``VNetLegacy``, any name of the
zoo; ``build_network(..., conv_impl="direct")`` builds the direct one.
``Remat: true`` recomputes the conv blocks (and the attention heads) in
the backward pass (``models/layers.py::recomputed``).
The host transforms' shared generator (``data/rand.py``) is seeded from
``Seed`` and the run's first step when training starts, so a run with one
loader worker (``LoaderWorkers: 1`` or 0) draws the same crops every time;
the JAX trainer leaves it seeded from the operating system.

Eager PyTorch: the step is forward (the network in train mode, dropout
keyed by the step's seed), loss, ``backward``, optimizer step, in place on
the network and optimizer that :class:`TrainState` holds. The loop
keeps the JAX trainer's semantics: a checkpoint every ``LogInterval`` steps
and at the end of every ``CheckpointEveryNEpochs``-th epoch, the epoch
counter inside the checkpoint so a resumed run continues it, ``Restore:
false`` wipes the log and checkpoint directories, ``MaxIterations`` stops
training (with a checkpoint), an optional test batch every ``TestStep``
steps, and a training set that yields no batch is an error. ``ScanSteps``
K > 1 runs K steps back to back on K buffered batches (the JAX package's
``lax.scan`` block), timed as one block; attention networks run K = 1, as
in JAX. ``network_config.json`` beside the checkpoints records the
architecture, key for key as the JAX trainer writes it.

A 2D ``PatchShape`` trains the 2D network (``spatial_rank=2``) on slices:
``NiftiDataset2D`` with the pipeline's ``{"3D", "2D"}`` chains,
``MinPixel``, ``DropRatio`` and ``CacheCases``, as the JAX trainer builds
it; the test phase's crops go through ``eval_step`` at their own size (the
network is fully convolutional).

``Attention: true`` trains ``AttentionVNet`` (3D): the loader adds the distance
map of each label and the step adds the gate's distance loss to the
segmentation loss. ``DeviceAugment: true`` takes ``RandomFlip`` and
``RandomNoise`` out of the host chain and runs them in the step on the
device (``data/device_aug.py``), from a generator seeded by the step's
dropout seed, so a resumed run repeats its augmentation; in 2D the flip
stays in the host chain, as in JAX.

Logs: each tag directory ``LogDir/<tag>/`` gets a TensorBoard events file
(``train/events.py``; the JAX trainer's tags) and ``scalars.jsonl`` (one
JSON object per value: ``tag``, ``step``, ``value``). ``ImageLog`` adds the
input, label, softmax and prediction images at every ``LogInterval``
checkpoint and every test step. ``trace=TraceCapture(..., steps=(start,
count))`` profiles a window of the loop's steps: the loop calls its
``step()`` after each step (a ``ScanSteps`` block counts as one).

Data parallelism (``parallel/mesh.py``), run inside a process group, one
process a GPU: the data axis takes ``Mesh.DataParallel`` ranks, or for 0
``gcd(BatchSize, ranks)``, as the JAX trainer sizes its mesh, and must be
the whole group; ``DcnDataParallel`` lays it over nodes, DCN-major. Each
rank builds the same network on ``cuda:<local rank>`` (rank 0's weights
broadcast at start and after a resume), loads only its block of each
global batch (``batch_rows``; the loader's ``rows``), and runs the step
inside ``data_parallel(mesh)``: batch statistics, dropout masks and the
device augmentation's draws are the global batch's, the gradients are
averaged over the ranks before the optimizer (one all-reduce), and the
logged loss, aux values and metrics are global. So a step at R ranks
computes what one process computes on the global batch. Only rank 0
writes checkpoints, ``network_config.json`` and the logs; the others wait
at a barrier where a later read needs the files. ``ImageLog`` shows rank
0's rows.

Spatial partitioning (``Mesh.SpaceParallel`` S > 1, ``parallel/spatial.py``):
the ranks form a ``(data, space)`` grid, data-major; every rank of a data
row loads the row's samples and keeps its slab of the first spatial axis
(the patch's first extent must be a multiple of ``S * 2**levels``, its
bottom slab at least one conv halo; with several loader threads the row's
first space rank's batch is broadcast to the row, so the ranks hold the
same crops whatever order the threads drew them in), and the step runs in
the mesh's
partition: halos at every stencil convolution, packing planned on the
global extents, batch statistics over the whole grid, the loss statistics
summed over the row, the gradients summed over the row and averaged over
the rows, dropout the slab of the unsharded mask, the device flip and
noise drawn for the whole patch (a flip along the sharded axis takes the
mirrored slab, which the rank uploads beside its own). So the step
computes the unsharded step's loss, gradients (up to summation order),
running averages and dropout masks, as JAX's GSPMD trainer does. The
checkpoints hold the unsharded network: a run resumes at any
``SpaceParallel``. ``ImageLog`` runs rank 0's whole rows unsharded.
Attention networks and ``Dense`` do not take a partition and raise.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config, load_pipeline
from ..data import (BatchLoader, NiftiDataset2D, NiftiDataset3D,
                    build_pipeline)
from ..data import rand
from ..data.device_aug import flip_coins, flip_where, random_noise
from ..data.transforms3d import RandomFlip, RandomNoise
from ..models import attention_distance_loss, build_network, eval_apply
from ..ops.losses import segmentation_loss
from ..ops.metrics import batch_metrics
from ..parallel.mesh import (Mesh, batch_rows, data_parallel,
                             data_parallel_size, make_mesh,
                             make_multislice_mesh)
from ..parallel.spatial import current_partition, validate_partition
from ..profiler import StepTimer, TraceCapture, span
from . import checkpoints
from .events import EventWriter
from .images import log_batch_images
from .optim import build_optimizer, set_learning_rate

# second word of the augmentation generator's seed: a torch Philox key
# (seed, AUGMENT_KEY) that no dropout layer's key (seed, index) shares
AUGMENT_KEY = 0xD1CE


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


def augment_generator(device: torch.device,
                      dropout_seed: int) -> torch.Generator:
    """The device generator of one step's augmentation, seeded from the
    step's dropout seed."""
    seed = (AUGMENT_KEY << 32) | (int(dropout_seed) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(seed)


def _global_output(mesh: Optional[Mesh], loss, aux, metrics
                   ) -> TrainStepOutput:
    """The step's values, loss and aux averaged over the ranks (one
    all-reduce; the ranks' shards are equal, so this is the global batch's
    mean)."""
    if mesh is None or not mesh.parallel:
        return TrainStepOutput(loss.detach(),
                               {k: v.detach() for k, v in aux.items()},
                               metrics)
    vals = mesh.mean(torch.stack([loss.detach()]
                                 + [v.detach() for v in aux.values()]))
    return TrainStepOutput(vals[0], dict(zip(aux, vals[1:])), metrics)


def make_train_step(loss_cfg, num_classes: int,
                    schedule: Callable[[int], float],
                    compute_metrics: bool = True, compute_auc: bool = False,
                    is_attention: bool = False, mesh: Optional[Mesh] = None):
    """The train step ``(state, images, labels, dropout_seed,
    distance_maps=None, device_augment=None) -> TrainStepOutput``: images
    ``(B, *spatial, C)``
    float, labels ``(B, *spatial)`` int and, for an attention network,
    distance maps ``(B, x, y, z)`` float on the network's device. Updates
    ``state`` in place (parameters, running averages, optimizer state,
    ``step``); the gradients stay in the parameters' ``.grad``. Returned
    values stay on the device.

    ``device_augment``: ``(flip_axes, noise_sigma)``: each sample flips
    (images, labels and distance maps with one coin) and the images get
    Gaussian noise before the forward pass.

    ``mesh``: a data-parallel mesh; the tensors are then the rank's rows
    (``batch_rows``) of a global batch of ``B * mesh.data``, and the step
    is that batch's: global batch statistics and dropout masks, the
    augmentation's draws for the global batch sliced to the rank's rows,
    gradients averaged over the ranks, global logged values. With
    ``mesh.space > 1`` the tensors are the rank's slab (``Mesh.slab``) of
    the first spatial axis of those rows and the step runs in the mesh's
    partition; ``mirror``: ``(images, labels)`` of the mirrored slab,
    which a device flip along that axis needs."""

    def step_fn(state: TrainState, images, labels, dropout_seed: int,
                distance_maps=None,
                device_augment: Optional[Tuple[tuple, float]] = None,
                mirror=None):
        net, opt = state.network, state.optimizer
        net.train()
        if device_augment is not None:
            flip_axes, noise_sigma = device_augment
            gen = augment_generator(images.device, dropout_seed)
            n = images.shape[0] * (1 if mesh is None else mesh.data)
            lo, hi = (0, n) if mesh is None else batch_rows(mesh, n)
            slab = None
            if mesh is not None and mesh.space > 1:
                full = images.shape[1] * mesh.space
                slab = mesh.slab(full) + (full,)
            if flip_axes:
                coins = flip_coins(gen, n, images.device)[lo:hi]
                sharded = slab is not None and 0 in flip_axes
                images = flip_where(images, coins, flip_axes,
                                    mirror[0] if sharded else None)
                labels = flip_where(labels, coins, flip_axes,
                                    mirror[1] if sharded else None)
                if distance_maps is not None:
                    distance_maps = flip_where(distance_maps, coins,
                                               flip_axes)
            if noise_sigma > 0.0:
                images = random_noise(gen, images, noise_sigma,
                                      rows=(lo, hi, n), slab=slab)
        set_learning_rate(opt, schedule, state.step)  # pre-increment count
        opt.zero_grad(set_to_none=True)
        with data_parallel(mesh):
            with span("vnet.train.forward"):
                out = net(images, dropout_seed=dropout_seed)
                logits = out[0] if is_attention else out
                loss, aux = segmentation_loss(
                    logits, labels, name=loss_cfg.name,
                    num_classes=num_classes, weights=loss_cfg.weights,
                    alpha=loss_cfg.alpha, partition=current_partition())
                if is_attention and distance_maps is not None:
                    att_loss = attention_distance_loss(
                        out[1], distance_maps, kind=loss_cfg.attention_kind,
                        scale=loss_cfg.attention_scale)
                    aux = dict(aux, attention_loss=att_loss)
                    loss = loss + att_loss
                    aux["total_loss"] = loss
            with span("vnet.train.backward"):
                loss.backward()
        if mesh is not None:
            mesh.average_gradients(net.parameters())
        opt.step()
        state.step += 1
        logits = logits.detach()
        metrics = (batch_metrics(logits, labels, num_classes,
                                 compute_auc=compute_auc,
                                 reduce=None if mesh is None else mesh.sum)
                   if compute_metrics else {})
        return _global_output(mesh, loss, aux, metrics)

    return step_fn


def make_eval_step(loss_cfg, num_classes: int, compute_auc: bool = False,
                   is_attention: bool = False, mesh: Optional[Mesh] = None):
    """Loss and metrics of a test batch, updating nothing (an attention
    network's first output and the segmentation loss only); with ``mesh``,
    of the global batch whose rows the ranks hold, batch statistics
    (``Norm: batch_stats``) included."""

    def step_fn(state: TrainState, images, labels):
        with data_parallel(mesh), torch.inference_mode():
            out = eval_apply(state.network, images)
            logits = out[0] if is_attention else out
            loss, aux = segmentation_loss(
                logits, labels, name=loss_cfg.name, num_classes=num_classes,
                weights=loss_cfg.weights, alpha=loss_cfg.alpha,
                partition=current_partition())
            metrics = batch_metrics(
                logits, labels, num_classes, compute_auc=compute_auc,
                reduce=None if mesh is None else mesh.sum)
            return _global_output(mesh, loss, aux, metrics)

    return step_fn


class TagLog:
    """The logs of one tag directory: a TensorBoard events file and
    ``scalars.jsonl``, both append-only."""

    def __init__(self, directory: str):
        self.events = EventWriter(directory)
        self._file = open(os.path.join(directory, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.events.add_scalar(tag, value, step)
        self._file.write(json.dumps({"tag": tag, "step": int(step),
                                     "value": float(value)}) + "\n")

    def add_image(self, tag: str, img, step: int,
                  dataformats: str = "HWC") -> None:
        self.events.add_image(tag, img, step, dataformats=dataformats)

    def flush(self) -> None:
        self.events.flush()
        self._file.flush()

    def close(self) -> None:
        self.events.close()
        self._file.close()


def trainer_mesh(t, device="cuda") -> Mesh:
    """The trainer's mesh in this process group (one rank without a
    group): ``DcnDataParallel`` > 1 lays the data axis over nodes; else
    ``DataParallel`` ranks, 0 for ``gcd(BatchSize, ranks)``."""
    if t.mesh_dcn_parallel > 1:
        return make_multislice_mesh(t.mesh_data_parallel,
                                    t.mesh_dcn_parallel,
                                    t.mesh_space_parallel, device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    space = max(int(t.mesh_space_parallel), 1)
    return make_mesh(data_parallel_size(t.batch_size, t.mesh_data_parallel,
                                        world // space),
                     space, device)


class Trainer:
    """End-to-end training, configured like the JAX trainer; data-parallel
    over the ranks of ``mesh`` (by default :func:`trainer_mesh`)."""

    def __init__(self, config: Config, device="cuda", log: bool = True,
                 mesh: Optional[Mesh] = None,
                 trace: Optional[TraceCapture] = None):
        self.config = config
        self.trace = trace
        self.t = t = config.train
        self.mesh = mesh if mesh is not None else trainer_mesh(t, device)
        self.rows = batch_rows(self.mesh, t.batch_size)
        self.device = self.mesh.device
        self.log_enabled = log and self.mesh.rank == 0
        net_cfg = t.network
        self.dtype = (torch.bfloat16 if t.precision == "bfloat16"
                      else torch.float32)
        name = "AttentionVNet" if net_cfg.attention else net_cfg.name
        self.is_attention = name == "AttentionVNet"
        self.network = build_network(
            name, num_classes=t.num_classes,
            in_channels=t.input_channels, dropout_rate=net_cfg.dropout,
            num_channels=net_cfg.num_channel, num_levels=net_cfg.num_levels,
            num_convolutions=net_cfg.num_convolutions,
            bottom_convolutions=net_cfg.bottom_convolutions,
            norm=net_cfg.norm, dtype=self.dtype, device=self.device,
            generator=torch.Generator().manual_seed(t.seed),
            packed_target_lanes=net_cfg.packed_target_lanes,
            dropout_impl=net_cfg.dropout_impl, remat=net_cfg.remat,
            legacy_double_norm=net_cfg.name == "VNetLegacy",
            dw_impl=net_cfg.dw_impl, spatial_rank=t.dimension,
            patch_shape=t.patch_shape)
        if self.mesh.space > 1:
            if self.is_attention or name in ("Dense", "SwinUNETR"):
                raise NotImplementedError(
                    f"Mesh.SpaceParallel={self.mesh.space}: {name} does not "
                    "take a spatial partition (VNet, VNetLegacy and UNet "
                    "do; SwinUNETR's windows and instance norms cross the "
                    "slabs)")
            validate_partition(t.patch_shape, 0, self.mesh.space,
                               self.network.num_levels,
                               kernel_halo=1 if name == "UNet" else 2)
        self.optimizer, self.lr_schedule = build_optimizer(
            t.optimizer, self.network.parameters())
        self._train_step_fn = make_train_step(
            t.loss, t.num_classes, self.lr_schedule,
            compute_auc=t.compute_auc, is_attention=self.is_attention,
            mesh=self.mesh)
        self._eval_step_fn = make_eval_step(t.loss, t.num_classes,
                                            compute_auc=t.compute_auc,
                                            is_attention=self.is_attention,
                                            mesh=self.mesh)
        self._device_aug = None  # (flip_axes, noise_sigma) when enabled
        self._writers = {}

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        return TrainState(self.network, self.optimizer)

    def _tensor(self, array, dtype) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array, dtype)).to(
            self.device, non_blocking=True)

    def _slabs(self, images, labels):
        """The rank's slab of the first spatial axis of host rows, and the
        mirrored slab when a device flip along that axis needs it."""
        mesh = self.mesh
        if mesh.space == 1:
            return images, labels, None
        s0, s1 = mesh.slab(np.shape(images)[1])
        mirror = None
        if self._device_aug is not None and 0 in self._device_aug[0]:
            m0, m1 = np.shape(images)[1] - s1, np.shape(images)[1] - s0
            mirror = (self._tensor(np.asarray(images)[:, m0:m1], np.float32),
                      self._tensor(np.asarray(labels)[:, m0:m1], np.int32))
        return (np.asarray(images)[:, s0:s1], np.asarray(labels)[:, s0:s1],
                mirror)

    def train_step(self, state: TrainState, images, labels,
                   dropout_seed: int, distance_maps=None) -> TrainStepOutput:
        """One step on host arrays (the rank's rows of the global batch,
        whole patches); an attention network without distance maps
        regresses its gate to zero maps, as the JAX trainer does."""
        with span("vnet.train.step"):
            if self.is_attention and distance_maps is None:
                distance_maps = np.zeros(np.shape(labels), np.float32)
            dmaps = (None if distance_maps is None
                     else self._tensor(distance_maps, np.float32))
            images, labels, mirror = self._slabs(images, labels)
            return self._train_step_fn(
                state, self._tensor(images, np.float32),
                self._tensor(labels, np.int32), dropout_seed, dmaps,
                self._device_aug, mirror)

    def eval_step(self, state: TrainState, images, labels) -> TrainStepOutput:
        images, labels, _ = self._slabs(images, labels)
        return self._eval_step_fn(state, self._tensor(images, np.float32),
                                  self._tensor(labels, np.int32))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def build_loader(self, data_dir: str, phase: str) -> BatchLoader:
        t = self.t
        transforms = build_pipeline(load_pipeline(t.pipeline_path), phase,
                                    t.dimension)
        if t.device_augment and phase == "train" and t.dimension == 3:
            transforms = self._extract_device_augment(transforms)
        if t.dimension == 2:
            ds = NiftiDataset2D(
                data_dir, t.image_filenames, t.label_filename,
                transforms3D=transforms["3D"], transforms2D=transforms["2D"],
                train=True, labels=t.segmentation_classes,
                min_pixel=t.min_pixel, drop_ratio=t.drop_ratio,
                cache_cases=t.cache_cases)
        else:
            ds = NiftiDataset3D(
                data_dir, t.image_filenames, t.label_filename,
                transforms=transforms, train=True,
                labels=t.segmentation_classes, attention=self.is_attention,
                cache_cases=t.cache_cases)
        return BatchLoader(ds, t.batch_size, shuffle=True,
                           drop_remainder=True, num_workers=t.loader_workers,
                           backend=t.loader_backend, seed=t.seed,
                           rows=self.rows if self.mesh.parallel else None)

    def _extract_device_augment(self, transforms):
        """Take ``RandomFlip`` and ``RandomNoise`` out of the host chain;
        their parameters move into the train step."""
        kept = []
        flip_axes = ()
        noise_sigma = 0.0
        for tfm in transforms:
            if isinstance(tfm, RandomFlip):
                flip_axes = tuple(i for i, f in enumerate(tfm.axes) if f)
            elif isinstance(tfm, RandomNoise):
                noise_sigma = float(tfm.sigma)
            else:
                kept.append(tfm)
        if flip_axes or noise_sigma > 0.0:
            self._device_aug = (flip_axes, noise_sigma)
        return kept

    # ------------------------------------------------------------------
    def _writer(self, tag: str) -> Optional[TagLog]:
        if not self.log_enabled:
            return None
        if tag not in self._writers:
            self._writers[tag] = TagLog(os.path.join(self.t.log_dir, tag))
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

    def _log_images(self, tag: str, step: int, state: TrainState, images,
                    labels) -> None:
        """ImageLog: inputs, label, per-class softmax and prediction of the
        batch under the current weights (``train/images.py``)."""
        w = self._writer(tag)
        if w is None:
            return
        out = eval_apply(state.network, self._tensor(images, np.float32))
        logits = out[0] if self.is_attention else out
        softmax = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        log_batch_images(w, tag, np.asarray(images), np.asarray(labels),
                         softmax, np.argmax(softmax, axis=-1),
                         self.t.segmentation_classes, step)

    def _save(self, state: TrainState) -> None:
        """A checkpoint, and the logs so far on disk beside it (rank 0)."""
        if self.mesh.rank != 0:
            return
        checkpoints.save(self.t.ckpt_dir, state.network.state_dict(),
                         state.step, state.optimizer.state_dict(),
                         state.epoch)
        for w in self._writers.values():
            w.flush()

    def _write_network_sidecar(self, ckpt_dir: str) -> None:
        """``network_config.json`` beside the checkpoints: the architecture
        travels with the weights, with the JAX trainer's keys and values."""
        net = self.t.network
        sidecar = {
            "Networks": {
                "Name": net.name, "Dropout": net.dropout,
                "NumChannel": net.num_channel, "NumLevels": net.num_levels,
                "NumConvolutions": list(net.num_convolutions),
                "BottomConvolutions": net.bottom_convolutions,
                "Attention": net.attention, "Norm": net.norm,
                "PackedTargetLanes": net.packed_target_lanes,
                "DropoutImpl": net.dropout_impl, "Remat": net.remat,
                "DwImpl": net.dw_impl,
            },
            "SegmentationClasses": list(self.t.segmentation_classes),
            "PatchShape": list(self.t.patch_shape),
            "Precision": self.t.precision,
        }
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "network_config.json"), "w") as f:
            json.dump(sidecar, f, indent=2)

    # ------------------------------------------------------------------
    def train(self, max_steps: Optional[int] = None) -> TrainState:
        t, mesh = self.t, self.mesh
        if mesh.rank == 0:
            if not t.restore:
                for d in (t.log_dir, t.ckpt_dir):
                    if os.path.exists(d):
                        shutil.rmtree(d)
                    os.makedirs(d, exist_ok=True)
            self._write_network_sidecar(t.ckpt_dir)
        mesh.barrier()  # no rank reads the directories before they are set
        state = self.init_state()
        if t.restore:
            step = mesh.broadcast_object(
                checkpoints.latest_step(t.ckpt_dir))
            if step is not None:
                saved = checkpoints.restore_state(t.ckpt_dir, step)
                state.network.load_state_dict(saved["model"])
                state.optimizer.load_state_dict(saved["optimizer"])
                state.step, state.epoch = saved["step"], saved["epoch"]
                if mesh.rank == 0:
                    print(f"Restored checkpoint at step {state.step}, "
                          f"epoch {state.epoch}")
        mesh.broadcast_module(state.network)
        if self.trace is not None:
            self.trace.start()
        try:
            state = self._train_loop(state, max_steps)
        finally:
            if self.trace is not None:
                self.trace.stop()
            for w in self._writers.values():
                w.close()
            self._writers = {}
        mesh.barrier()  # rank 0's last checkpoint is on disk
        return state

    def _row_batch(self, batch):
        """The row's batch, the same on every space rank of the row: a
        threaded loader with several workers draws the host randomness in
        the threads' order, so the first space rank's batch is broadcast
        to the row; one worker (or the process backend's per-sample seeds)
        draws the same on every rank."""
        t = self.t
        if (self.mesh.space > 1 and t.loader_workers > 1
                and t.loader_backend != "process"):
            return self.mesh.broadcast_row(batch)
        return batch

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
        # the host transforms' shared generator (data/rand.py), from Seed,
        # the first step and the data row (the space ranks of a row draw
        # alike, the rows apart): with one loader worker a run repeats
        # itself
        rand.seed([t.seed, state.step, self.mesh.data_index])
        train_loader = self.build_loader(t.data_dir, "train")
        test_loader = (self.build_loader(t.test_data_dir, "test")
                       if t.testing and t.test_data_dir else None)
        test_iter = (iter(()) if test_loader is None
                     else iter(test_loader.epoch()))
        seeds = self._dropout_seeds(state.step)
        timer = StepTimer(warmup=2)
        limit = t.max_iterations if max_steps is None else max_steps
        scan_k = 1 if self.is_attention else max(1, t.scan_steps)
        scan_buf = []  # carries across epochs, as the JAX trainer's
        for epoch in range(state.epoch, t.epochs):
            epoch_loss, count = 0.0, 0
            t0 = time.time()
            pending = None  # (step, out), logged one step late
            epoch_batches = 0
            for batch in train_loader.epoch():
                images, labels, *rest = self._row_batch(batch)
                epoch_batches += 1
                if state.step >= limit:
                    if self.mesh.rank == 0:
                        print("Reach maximum iteration steps, training "
                              "abort.")
                    self._save(state)
                    return state
                scan_buf.append((images, labels, rest[0] if rest else None))
                if len(scan_buf) < scan_k:
                    continue
                with timer:
                    outs = [self.train_step(state, im, lb, next(seeds), dm)
                            for im, lb, dm in scan_buf]
                    self._sync()
                if self.trace is not None:
                    self.trace.step()
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
                    if t.image_log:
                        self._log_images("train", state.step, state, images,
                                         labels)

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
                        timages, tlabels, *_ = self._row_batch(test_batch)
                        self._log_scalars("test", state.step, self.eval_step(
                            state, timages, tlabels))
                        if t.image_log:
                            self._log_images("test", state.step, state,
                                             timages, tlabels)

            if epoch_batches == 0:
                raise ValueError(
                    "Training dataset yields no batches: fewer cases than "
                    f"BatchSize={t.batch_size} with drop_remainder (the "
                    "reference's tf.data semantics). Lower BatchSize or add "
                    "training cases.")
            if pending is not None:
                epoch_loss += self._log_scalars("train", *pending)
                count += 1
            if count and self.mesh.rank == 0:
                print(f"Epoch {epoch + 1}: loss {epoch_loss / count:.4f} "
                      f"({count} steps, {time.time() - t0:.1f}s)")
            state.epoch += 1
            n_ck = max(1, t.ckpt_every_n_epochs)
            if (epoch + 1) % n_ck == 0 or epoch + 1 == t.epochs:
                self._save(state)
        return state
