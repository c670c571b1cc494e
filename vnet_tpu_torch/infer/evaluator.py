"""Whole-volume evaluation, 3D, one device.

Counterpart of ``vnet_tpu/infer/evaluator.py`` (``evaluate_single_3d``,
``evaluate_case``, ``evaluate``): per case, read the image channels, apply
the evaluation transform chain (the port's ``data`` package), run the
sliding window, argmax the blended softmax (or average the hard
predictions, ``LabelMode: average_hard``), resample the label (nearest)
and the probability maps (linear, softmax / weight) back onto the original
image grid, then largest connected component, volume threshold and the
optional probability masking, and write NIfTI files.

Weights come from ``state_dict`` or from the newest port checkpoint under
``EvaluationSetting.CheckpointPath`` (``train/checkpoints.py``). The blend
is the CUDA kernel for ``BlendImpl`` ``auto`` / ``pallas`` on a CUDA
device; the CPU runs only when ``device`` says so.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, load_pipeline
from ..data import build_pipeline, list_cases
from ..device import resolve_device
from ..io import (LINEAR, NEAREST, MedicalImage, pad_to_size, read_image,
                  resample_like, write_image, zeros_like_geometry)
from ..models import build_network, eval_apply
from ..train import checkpoints
from .postprocess import extract_largest_connected_component, volume_threshold
from .sliding_window import SlidingWindowInference


def _stack_channels(images: List[MedicalImage]) -> np.ndarray:
    return np.stack([np.asarray(im.data, np.float32) for im in images],
                    axis=-1)


class Evaluator:
    """Config-driven evaluation engine (3D)."""

    def __init__(self, config: Config,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda"):
        self.config = config
        self.t = config.train
        self.e = config.evaluate
        self.device = resolve_device(device)
        if self.t.dimension != 3:
            raise NotImplementedError(
                "2D evaluation is not ported yet (ROADMAP.md)")
        net_cfg = self.t.network
        if net_cfg.attention:
            raise NotImplementedError(
                "AttentionVNet is not ported yet (ROADMAP.md)")

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
            net_cfg.name, num_classes=self.t.num_classes,
            in_channels=len(self.e.image_filenames), dropout_rate=0.0,
            num_channels=net_cfg.num_channel, num_levels=net_cfg.num_levels,
            num_convolutions=net_cfg.num_convolutions,
            bottom_convolutions=net_cfg.bottom_convolutions, norm=norm,
            dtype=dtype, device=self.device)
        if state_dict is None:
            state_dict = self._restore_state_dict()
        self.network.load_state_dict(state_dict)

        if self.e.label_mode not in ("argmax", "average_hard"):
            raise ValueError(f"unknown LabelMode {self.e.label_mode!r}")
        self.hard_mode = self.e.label_mode == "average_hard"
        self.engine = SlidingWindowInference(
            lambda patches: eval_apply(self.network, patches),
            self.t.patch_shape, self.e.stride, self.e.batch_size,
            self.t.num_classes, gaussian_blend=self.e.gaussian_blend,
            hard_accumulate=self.hard_mode, blend_impl=self.e.blend_impl,
            device=self.device)

    def _restore_state_dict(self) -> Dict[str, torch.Tensor]:
        path = self.e.checkpoint_path or self.t.ckpt_dir
        state_dict = checkpoints.restore_latest(path)
        if state_dict is None:
            raise FileNotFoundError(f"No port checkpoint (ckpt_<step>.pt) "
                                    f"found under {path!r}")
        return state_dict

    def _eval_transforms(self):
        return build_pipeline(load_pipeline(self.e.pipeline_path), "evaluate",
                              3)

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

    def evaluate_case(self, case_dir: str):
        sample = self._prepare_case(case_dir)
        if sample is None:
            return None
        label, probs = self.evaluate_single_3d(sample,
                                               self._eval_transforms())
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

    def evaluate(self) -> List[str]:
        """Evaluate every case under ``EvaluateDataDirectory`` and write the
        label (and probability maps) into each case directory."""
        results = []
        for case in list_cases(self.e.data_dir):
            case_dir = os.path.join(self.e.data_dir, case)
            out = self.evaluate_case(case_dir)
            if out is None:
                print(f"Image file not found at {case_dir}")
                continue
            label, probs = out
            label_path = os.path.join(case_dir, self.e.label_filename)
            write_image(label, label_path)
            results.append(label_path)
            if probs is not None:
                stem, ext = self._split_name(self.e.probability_filename)
                for c, prob in enumerate(probs):
                    class_id = self.t.segmentation_classes[c]
                    write_image(prob, os.path.join(
                        case_dir, f"{stem}_{class_id}{ext}"))
        return results

    @staticmethod
    def _split_name(filename: str) -> Tuple[str, str]:
        parts = filename.split(".")
        return parts[0], "".join("." + p for p in parts[1:])
