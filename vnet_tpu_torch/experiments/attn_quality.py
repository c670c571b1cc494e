"""Attention-gated V-Net quality run of the port — counterpart of the
repo's ``scripts/experiments/attn_quality.py``, through the port's flag
command lines:

  1. hard-synthetic dataset (96x96x64, 64 train / 4 eval cases, 0.6
     sigma, generator seed 42: the JAX script's cases), binary semantics
     per the legacy CLI (SegmentationClasses [0, 1]: class-2 blobs remap
     to background, unlabelled dark distractors);
  2. ``python -m vnet_tpu_torch.flags.train --attention --dropout_impl
     bits8 --device_augment`` with the quality3 recipe (statnorm + flip +
     crop drop 0.3 / min_pixel 32 + noise), 6000 steps, batch 8, 64^3;
  3. ``python -m vnet_tpu_torch.flags.evaluate --attention`` twice: the
     running averages (``--eval_norm ema``, the reference's attention
     evaluator) and batch statistics (``--eval_norm batch_stats``), each
     into its own label file;
  4. the per-case class-1 Dice table, and one JSON line of it last.

Resumable: the flag CLI restores the newest checkpoint by default, so a
second call continues the run. ``--remat`` is passed on to the trainer,
which recomputes the conv blocks and the attention heads in the backward
pass (the JAX script retries with it after an out-of-memory failure; the
port has no such retry: on the card the run at batch 8 fits without
it). ``--small`` is a tiny CPU-sized chain (48^3 volumes, 32^3
patches, 4 cases) that checks the steps, not the quality. ``--device``
(default ``cuda``) goes to both CLIs.

    python -m vnet_tpu_torch.experiments.attn_quality --workdir tmp/attn
    python -m vnet_tpu_torch.experiments.attn_quality --small --steps 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# the directory that holds the package, for the subprocesses' imports
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = {"ema": "ema", "bstats": "batch_stats"}


def sh(args):
    print("+", " ".join(args), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run(args, check=True, env=env)


def write_pipeline(path: str, patch: int) -> None:
    import yaml

    patch_l = [patch] * 3
    norm = {"name": "StatisticalNormalization", "variables": {"sigma": 2.5}}
    pad = {"name": "Padding", "variables": {"output_size": patch_l}}
    train3d = [norm, pad,
               {"name": "RandomFlip",
                "variables": {"axes": [True, True, True]}},
               {"name": "RandomCrop",
                "variables": {"output_size": patch_l, "drop_ratio": 0.3,
                              "min_pixel": 32}},
               {"name": "RandomNoise", "variables": {"sigma": 8}}]
    with open(path, "w") as f:
        yaml.safe_dump({"preprocess": {
            "train": {"3D": train3d},
            "test": {"3D": [norm, pad,
                            {"name": "RandomCrop",
                             "variables": {"output_size": patch_l,
                                           "drop_ratio": 1.0,
                                           "min_pixel": 0}}]},
            "evaluate": {"3D": [norm, pad]},
        }}, f)


def train_cmd(wd: str, ppath: str, args, patch: int, batch: int) -> list:
    return [sys.executable, "-m", "vnet_tpu_torch.flags.train",
            "--attention", "--data_dir", wd, "--pipeline", ppath,
            "--batch_size", str(batch),
            "--patch_size", str(patch), "--patch_layer", str(patch),
            "--max_iterations", str(args.steps),
            "--optimizer", "adam", "--init_learning_rate", "1e-3",
            "--loss_function", "sorensen",
            "--attention_loss_function", "l2",
            "--drop_ratio", "0.3", "--min_pixel", "32",
            "--dropout_impl", args.dropout_impl,
            *(["--remat"] if args.remat else []),
            "--cache_cases", "64", "--device_augment",
            "--display_step", "50", "--save_interval", "20",
            "--log_dir", os.path.join(wd, "log"),
            "--checkpoint_dir", os.path.join(wd, "ckpt"),
            "--device", args.device]


def evaluate_cmd(wd: str, ppath: str, args, patch: int, tag: str,
                 eval_norm: str) -> list:
    return [sys.executable, "-m", "vnet_tpu_torch.flags.evaluate",
            "--attention", "--data_dir", os.path.join(wd, "evaluate"),
            "--checkpoint_path", os.path.join(wd, "ckpt"),
            "--pipeline", ppath,
            "--patch_size", str(patch), "--patch_layer", str(patch),
            "--stride_inplane", str(patch // 2),
            "--stride_layer", str(patch // 2),
            "--batch_size", "4", "--eval_norm", eval_norm,
            "--label_filename", f"pred_{tag}.nii.gz",
            "--device", args.device]


def main(argv=None) -> dict:
    """The four steps; returns ``{mode: {case: [dice per class]}}``."""
    ap = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.experiments.attn_quality")
    ap.add_argument("--workdir", default="tmp/attn_quality")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--dropout_impl", default="bits8")
    ap.add_argument("--remat", action="store_true",
                    help="passed on to the trainer: recompute the conv "
                         "blocks and heads in backward (Networks.Remat)")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny CPU-sized chain (48^3 volumes, 32^3 patches, "
                         "4 cases) — verifies the full chain, not quality")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both command lines (cuda or cpu)")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    resolve_device(args.device)  # no card: fail before generating data

    shape, n_train, n_eval = ((48, 48, 48), 4, 2) if args.small \
        else ((96, 96, 64), 64, 4)
    patch, batch = (32, 2) if args.small else (64, 8)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)

    if not os.path.isdir(os.path.join(wd, "training")):
        from ..utils.synthdata import make_hard_dataset

        print(f"generating dataset under {wd} ...", flush=True)
        rng = np.random.default_rng(42)
        make_hard_dataset(wd, "training", n_train, rng, shape=shape)
        make_hard_dataset(wd, "testing", max(2, n_train // 8), rng,
                          shape=shape)
        make_hard_dataset(wd, "evaluate", n_eval, rng, shape=shape)

    ppath = os.path.join(wd, "pipeline.yaml")
    if not os.path.isfile(ppath):
        write_pipeline(ppath, patch)

    sh(train_cmd(wd, ppath, args, patch, batch))
    if args.train_only:
        return {}

    # two evaluations through --eval_norm: the checkpoint's sidecar is
    # never edited
    for tag, eval_norm in MODES.items():
        sh(evaluate_cmd(wd, ppath, args, patch, tag, eval_norm))

    from ..io import read_image
    from ..utils.synthdata import dice_per_class

    ev_dir = os.path.join(wd, "evaluate")
    table = {}
    for tag in MODES:
        print(f"--- attention quality, {tag} eval ---", flush=True)
        table[tag] = {}
        for case in sorted(os.listdir(ev_dir)):
            cdir = os.path.join(ev_dir, case)
            truth = np.asarray(read_image(
                os.path.join(cdir, "label.nii")).data)
            truth = (truth == 1).astype(np.int32)  # binary legacy semantics
            pred = np.asarray(read_image(
                os.path.join(cdir, f"pred_{tag}.nii.gz")).data)
            d = [float(x) for x in dice_per_class(pred, truth, 2)]
            table[tag][case] = d
            print(f"{case} [{tag}]: dice per class "
                  f"{[round(x, 3) for x in d]}", flush=True)
    print(json.dumps({"attn_quality": {"steps": args.steps,
                                       "dice": table}}), flush=True)
    return table


if __name__ == "__main__":
    main()
