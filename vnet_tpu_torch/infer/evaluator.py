"""Whole-volume evaluation, 2D or 3D, on one device or data-parallel.

Counterpart of ``vnet_tpu/infer/evaluator.py`` (``evaluate_single_3d``,
``evaluate_single_2d``, ``evaluate_case``, ``evaluate``): per case, read the
image channels, apply the evaluation transform chain (the port's ``data``
package), run the sliding window, argmax the blended softmax (or average
the hard predictions, ``LabelMode: average_hard``, 3D only), resample the
label (nearest) and the probability maps (linear, softmax / weight) back
onto the original image grid, then largest connected component, volume
threshold and the optional probability masking, and write NIfTI files.

A 2D ``PatchShape`` segments the volume slice by slice: the 3D transforms
on the volume, then per z-slice ``extract_slice``, the 2D transforms and a
pad to the patch; every plane of one shape goes through one slice-stacked
engine call (ragged planes take the per-slice engine, one call each), and
each slice's label and probabilities are resampled onto the original slice
and pasted into the volume. ``EvalNorm: batch_stats`` keeps the reference's
documented 2D behaviour (batch statistics of patches that straddle slices).

The network is built as the JAX evaluator builds it: packed convolutions
at the config's ``PackedTargetLanes``, ``VNetLegacy``'s double norm, any
name of the zoo (``Dense`` at the training ``PatchShape``).

``Attention: true`` evaluates ``AttentionVNet`` and blends its first
output, the refined logits. Weights come from ``state_dict`` or from the
newest port checkpoint under ``EvaluationSetting.CheckpointPath``
(``train/checkpoints.py``). The blend
is the CUDA kernel for ``BlendImpl`` ``auto`` / ``pallas`` on a CUDA
device; the CPU runs only when ``device`` says so.

In a process group of R > 1 ranks (``parallel/mesh.py``), as JAX's
evaluator shards its grid whenever it sees more than one device, every
rank builds the network on its device with rank 0's weights (broadcast),
runs its block of each case's patch grid and receives the summed
accumulators (``SlidingWindowInference``'s ``mesh``); only rank 0 writes
labels and probability maps, and every rank returns once they are on disk.
"""

from __future__ import annotations

import functools
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, load_pipeline
from ..data import build_pipeline, list_cases
from ..data.dataset2d import extract_slice
from ..io import (LINEAR, NEAREST, MedicalImage, pad_to_size, read_image,
                  resample_like, write_image, zeros_like_geometry)
from ..models import build_network, eval_apply
from ..parallel.mesh import Mesh, make_mesh
from ..train import checkpoints
from .postprocess import extract_largest_connected_component, volume_threshold
from .sliding_window import SlidingWindowInference


def _stack_channels(images: List[MedicalImage]) -> np.ndarray:
    return np.stack([np.asarray(im.data, np.float32) for im in images],
                    axis=-1)


class Evaluator:
    """Config-driven evaluation engine (2D or 3D, by ``PatchShape``)."""

    def __init__(self, config: Config,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", mesh: Optional[Mesh] = None):
        self.config = config
        self.t = config.train
        self.e = config.evaluate
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.device = self.mesh.device
        net_cfg = self.t.network
        name = "AttentionVNet" if net_cfg.attention else net_cfg.name
        self.is_attention = name == "AttentionVNet"

        # EvalNorm overrides the network's batch-norm kind
        norm = net_cfg.norm
        if norm in ("batch", "batch_stats"):
            if self.e.eval_norm == "ema":
                norm = "batch"
            elif self.e.eval_norm == "batch_stats":
                norm = "batch_stats"
        elif self.e.eval_norm != "network":
            warnings.warn(f"EvalNorm {self.e.eval_norm!r} has no effect on "
                          f"Norm {norm!r} (no batch statistics)",
                          stacklevel=2)
        dtype = (torch.bfloat16 if self.t.precision == "bfloat16"
                 else torch.float32)
        self.network = build_network(
            name, num_classes=self.t.num_classes,
            in_channels=len(self.e.image_filenames), dropout_rate=0.0,
            num_channels=net_cfg.num_channel, num_levels=net_cfg.num_levels,
            num_convolutions=net_cfg.num_convolutions,
            bottom_convolutions=net_cfg.bottom_convolutions, norm=norm,
            packed_target_lanes=net_cfg.packed_target_lanes,
            legacy_double_norm=net_cfg.name == "VNetLegacy",
            dtype=dtype, device=self.device, spatial_rank=self.t.dimension,
            patch_shape=self.t.patch_shape)
        if state_dict is None:
            state_dict = self._restore_state_dict()
        self.network.load_state_dict(state_dict)
        self.mesh.broadcast_module(self.network)

        if self.e.label_mode not in ("argmax", "average_hard"):
            raise ValueError(f"unknown LabelMode {self.e.label_mode!r}")
        self.hard_mode = self.e.label_mode == "average_hard"
        if self.hard_mode and self.t.dimension == 2:
            raise ValueError(
                "LabelMode 'average_hard' is the legacy 3D evaluator mode "
                "(the reference's evaluate.py is 3D-only)")
        engine = functools.partial(
            SlidingWindowInference, self._apply, self.t.patch_shape,
            self.e.stride, self.e.batch_size, self.t.num_classes,
            gaussian_blend=self.e.gaussian_blend,
            blend_impl=self.e.blend_impl, device=self.device, mesh=self.mesh)
        # 2D: self.engine is the per-slice engine for ragged planes
        self.engine = engine(hard_accumulate=self.hard_mode)
        self.engine_stacked = (engine(slice_stacked=True)
                               if self.t.dimension == 2 else None)

    def _apply(self, patches: torch.Tensor) -> torch.Tensor:
        out = eval_apply(self.network, patches)
        return out[0] if self.is_attention else out

    def _restore_state_dict(self) -> Dict[str, torch.Tensor]:
        path = self.e.checkpoint_path or self.t.ckpt_dir
        state_dict = checkpoints.restore_latest(path)
        if state_dict is None:
            raise FileNotFoundError(f"No port checkpoint (ckpt_<step>.pt) "
                                    f"found under {path!r}")
        return state_dict

    def _eval_transforms(self):
        return build_pipeline(load_pipeline(self.e.pipeline_path), "evaluate",
                              self.t.dimension)

    def _prepare_case(self, case_dir: str) -> Optional[dict]:
        images = []
        for fname in self.e.image_filenames:
            path = os.path.join(case_dir, fname)
            if not os.path.exists(path):
                return None
            images.append(read_image(path))
        return {"image": images, "label": zeros_like_geometry(images[0])}

    def evaluate_single_3d(self, sample, transforms):
        """Returns ``(label, probs | None)`` on the original image grid."""
        original = sample["image"][0]
        for tfm in transforms:
            sample = tfm(sample)
        images = [pad_to_size(im, self.t.patch_shape, LINEAR)
                  for im in sample["image"]]
        transformed_geom = images[0]

        acc, weight = self.engine(_stack_channels(images))
        acc = acc.cpu().numpy()
        weight = weight.cpu().numpy()

        if self.hard_mode:
            # channel 0 holds the hard-prediction sum: rint(sum/visits + 0.01)
            label_np = np.rint(
                acc[..., 0] / np.maximum(weight, 1e-12) + 0.01
            ).astype(np.uint8)
            acc = acc[..., 1:]
        else:
            label_np = np.argmax(acc, axis=-1).astype(np.uint8)
        label = resample_like(transformed_geom.like(label_np), original,
                              NEAREST)
        if not self.e.probability_output:
            return label, None
        probs = []
        for c in range(self.t.num_classes):
            prob_np = acc[..., c] / np.maximum(weight, 1e-12)
            probs.append(resample_like(
                transformed_geom.like(prob_np.astype(np.float32)), original,
                LINEAR))
        return label, probs

    def evaluate_single_2d(self, sample, transforms):
        """Per-z-slice 2D sliding window, results pasted back into the
        volume; returns ``(label, probs | None)`` on the original image
        grid. All planes of one shape run as one slice-stacked grid, ragged
        ones slice by slice: the same batches as JAX's engines."""
        for tfm in transforms["3D"]:
            sample = tfm(sample)
        images3d, label3d = sample["image"], sample["label"]
        size = images3d[0].GetSize()
        out_label = np.zeros(size, np.uint8)
        out_probs = (np.zeros((self.t.num_classes,) + size, np.float32)
                     if self.e.probability_output else None)

        planes, geoms, orig_slices = [], [], []
        for z in range(size[2]):
            slice_imgs = [extract_slice(im, z) for im in images3d]
            orig_slices.append(slice_imgs[0])
            s = {"image": slice_imgs, "label": extract_slice(label3d, z)}
            for tfm in transforms["2D"]:
                s = tfm(s)
            slice_imgs = [pad_to_size(im, self.t.patch_shape, LINEAR)
                          for im in s["image"]]
            geoms.append(slice_imgs[0])
            planes.append(_stack_channels(slice_imgs))

        if planes and all(p.shape == planes[0].shape for p in planes):
            acc3, w3 = self.engine_stacked(np.stack(planes))
            acc3, w3 = acc3.cpu().numpy(), w3.cpu().numpy()
            per_slice = list(zip(acc3, w3))
        else:  # ragged transformed shapes: one engine call per slice
            per_slice = []
            for plane in planes:
                acc, weight = self.engine(plane)
                per_slice.append((acc.cpu().numpy(), weight.cpu().numpy()))

        for z, (acc, weight) in enumerate(per_slice):
            geom, orig_slice = geoms[z], orig_slices[z]
            lbl = resample_like(
                geom.like(np.argmax(acc, axis=-1).astype(np.uint8)),
                orig_slice, NEAREST)
            out_label[:, :, z] = lbl.data
            if out_probs is not None:
                for c in range(self.t.num_classes):
                    p = acc[..., c] / np.maximum(weight, 1e-12)
                    out_probs[c, :, :, z] = resample_like(
                        geom.like(p.astype(np.float32)), orig_slice,
                        LINEAR).data

        label = images3d[0].like(out_label)
        if out_probs is None:
            return label, None
        return label, [images3d[0].like(out_probs[c])
                       for c in range(self.t.num_classes)]

    def evaluate_case(self, case_dir: str):
        sample = self._prepare_case(case_dir)
        if sample is None:
            return None
        evaluate = (self.evaluate_single_2d if self.t.dimension == 2
                    else self.evaluate_single_3d)
        label, probs = evaluate(sample, self._eval_transforms())
        if self.e.largest_connected_component:
            label = extract_largest_connected_component(label)
        if self.e.volume_threshold > 0:
            label = volume_threshold(label, self.e.volume_threshold)
            if self.e.mask_probability_with_label and probs is not None:
                # keep the prob map only where the thresholded label is 0
                mask = np.asarray(label.data) != 0
                probs = [pr.like(np.where(mask, 0.0, pr.data)
                                 .astype(np.float32)) for pr in probs]
        return label, probs

    def evaluate(self, max_cases: Optional[int] = None) -> List[str]:
        """Evaluate every case under ``EvaluateDataDirectory`` (the first
        ``max_cases`` of them, when given) and write the label (and
        probability maps) into each case directory."""
        results = []
        cases = list_cases(self.e.data_dir)
        if max_cases is not None:
            cases = cases[:max_cases]
        for case in cases:
            case_dir = os.path.join(self.e.data_dir, case)
            out = self.evaluate_case(case_dir)
            if out is None:
                print(f"Image file not found at {case_dir}")
                continue
            label, probs = out
            label_path = os.path.join(case_dir, self.e.label_filename)
            results.append(label_path)
            if self.mesh.rank != 0:
                continue
            write_image(label, label_path)
            if probs is not None:
                stem, ext = self._split_name(self.e.probability_filename)
                for c, prob in enumerate(probs):
                    class_id = self.t.segmentation_classes[c]
                    write_image(prob, os.path.join(
                        case_dir, f"{stem}_{class_id}{ext}"))
        self.mesh.barrier()
        return results

    @staticmethod
    def _split_name(filename: str) -> Tuple[str, str]:
        parts = filename.split(".")
        return parts[0], "".join("." + p for p in parts[1:])
