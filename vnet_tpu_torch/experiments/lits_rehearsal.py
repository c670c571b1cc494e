"""LiTS-shaped rehearsal of the port — counterpart of the repo's
``scripts/experiments/lits_rehearsal.py``: the reference's production
geometry (patch [256, 256, 32], loss weights [0.01, 0.1, 1], lr 1e-2 with
0.99/100 decay, DropRatio 0.01 / MinPixel 30) trained and evaluated at
reference scale on one card:

  * hard-synthetic dataset at LiTS-like geometry (320x320x48 volumes,
    <=1% foreground, 0.6 sigma contrast, bias field), generator seed 7:
    the JAX script's files;
  * the production ``Trainer`` at the reference patch shape (batch 8 by
    default, the JAX script's; ``--batch`` sets it);
  * patches/s at that patch (wall clock over the whole run, first-call
    warm-up included: a lower bound);
  * one whole-volume sliding-window evaluation at Stride [256, 256, 32].

The config it writes is the JAX script's, key for key (its network block
verbatim, ``Remat`` unset); ``--small`` is the same tiny CPU chain
(64x64x24 volumes, [48, 48, 16] patches, batch 2, a 4-channel 2-level
network, float32) and runs on the CPU, as the JAX script's ``--small``
does; otherwise it runs on the card.

    python -m vnet_tpu_torch.experiments.lits_rehearsal [--steps 200] \\
        [--batch 8]
    python -m vnet_tpu_torch.experiments.lits_rehearsal --small --steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def write_config(workdir: str, small: bool, steps: int, batch: int) -> str:
    """``pipeline.yaml`` and ``config.json`` under ``workdir``, as the JAX
    script writes them; returns the config's path."""
    import yaml

    if small:
        patch = [48, 48, 16]
        net = {"Name": "VNet", "Dropout": 0.0, "NumChannel": 4,
               "NumLevels": 2, "NumConvolutions": [1, 1],
               "BottomConvolutions": 1}
        n_train, precision = 2, "float32"
    else:
        patch = [256, 256, 32]
        # the reference LiTS network with the JAX script's tuning (bits8
        # dropout, lanes-128 packing), key for key (its "NumCovolutions"
        # leaves the default (1, 2, 3, 3))
        net = {"Name": "VNet", "Dropout": 0.1, "NumChannel": 16,
               "NumLevels": 4, "NumCovolutions": [1, 2, 3, 3],
               "BottomConvolutions": 3, "PackedTargetLanes": 128,
               "DropoutImpl": "bits8"}
        n_train, precision = 8, "bfloat16"
    statnorm = {"name": "StatisticalNormalization",
                "variables": {"sigma": 2.5}}
    pad = {"name": "Padding", "variables": {"output_size": patch}}
    pipeline = {"preprocess": {
        "train": {"3D": [
            statnorm, pad,
            {"name": "RandomCrop",
             "variables": {"output_size": patch,
                           "drop_ratio": 0.01, "min_pixel": 30}}]},
        "test": {"3D": [
            statnorm, pad,
            {"name": "RandomCrop",
             "variables": {"output_size": patch, "drop_ratio": 1.0,
                           "min_pixel": 0}}]},
        "evaluate": {"3D": [statnorm, pad]},
    }}
    ppath = os.path.join(workdir, "pipeline.yaml")
    with open(ppath, "w") as f:
        yaml.safe_dump(pipeline, f)
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": os.path.join(workdir,
                                                           "training"),
                     "TestingDataDirectory": os.path.join(workdir,
                                                          "testing"),
                     "ImageFilenames": ["image.nii"],
                     "LabelFilename": "label.nii"},
            "SegmentationClasses": [0, 1, 2],
            "BatchSize": batch,
            "PatchShape": patch,
            "Epoches": 10 ** 6,
            "MaxIterations": steps,
            "LogDir": os.path.join(workdir, "log"),
            "CheckpointDir": os.path.join(workdir, "ckpt"),
            "LogInterval": 50,
            "CheckpointEveryNEpochs": 10 ** 6,  # rehearsal: final save only
            "Precision": precision,
            "CacheCases": n_train,
            "Networks": net,
            "Loss": {"Name": "weighted_sorensen", "Weights": [0.01, 0.1, 1]},
            "Optimizer": {"Name": "Adam", "InitialLearningRate": 1e-2,
                          "Decay": {"Factor": 0.99, "Steps": 100}},
            "Pipeline": ppath,
        },
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": os.path.join(workdir,
                                                           "evaluate"),
                     "ImageFilenames": ["image.nii"],
                     "LabelFilename": "pred.nii.gz",
                     "ProbabilityOutput": False},
            "Stride": patch,  # reference EvaluationSetting.Stride
            "BatchSize": 4,
            "Pipeline": ppath,
        },
    }
    cpath = os.path.join(workdir, "config.json")
    with open(cpath, "w") as f:
        json.dump(tree, f, indent=2)
    return cpath


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.experiments.lits_rehearsal")
    ap.add_argument("--workdir", default="tmp/r5_lits")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="CPU smoke: tiny volumes/patches/net")
    args = ap.parse_args(argv)
    device = "cpu" if args.small else "cuda"
    from ..device import resolve_device

    resolve_device(device)  # no card: fail before generating data
    import numpy as np

    from ..utils.synthdata import dice_per_class, make_hard_dataset

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    shape = (64, 64, 24) if args.small else (320, 320, 48)
    n_train = 2 if args.small else 8
    if not os.path.isdir(os.path.join(workdir, "training")):
        print(f"generating LiTS-shaped dataset under {workdir} "
              f"(volumes {shape}) ...", flush=True)
        rng = np.random.default_rng(7)
        make_hard_dataset(workdir, "training", n_train, rng, shape=shape)
        make_hard_dataset(workdir, "testing", 1, rng, shape=shape)
        make_hard_dataset(workdir, "evaluate", 1, rng, shape=shape)
    batch = 2 if args.small else args.batch
    cpath = write_config(workdir, args.small, args.steps, batch)
    print(f"config written: {cpath}", flush=True)

    import torch

    from ..config import load_config
    from ..infer import Evaluator
    from ..io import read_image
    from ..train import Trainer

    cfg = load_config(cpath)
    patch = tuple(cfg.train.patch_shape)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"devices: {name}", flush=True)
    trainer = Trainer(cfg, device=device)
    t0 = time.perf_counter()
    state = trainer.train()
    wall = time.perf_counter() - t0
    print(f"LITS-REHEARSAL train: {args.steps} steps of b{batch} "
          f"{patch} patches in {wall:.1f} s "
          f"(>= {args.steps * batch / wall:.2f} patches/s incl. warm-up)",
          flush=True)

    ev = Evaluator(cfg, state_dict=state.network.state_dict(), device=device)
    t0 = time.perf_counter()
    results = ev.evaluate()
    print(f"LITS-REHEARSAL eval: {len(results)} case(s) at stride "
          f"{patch} in {time.perf_counter() - t0:.1f} s", flush=True)
    for pred_path in results:
        case_dir = os.path.dirname(pred_path)
        truth = np.asarray(read_image(
            os.path.join(case_dir, "label.nii")).data)
        pred = np.asarray(read_image(pred_path).data)
        d = dice_per_class(pred, truth, 3)
        print(f"{os.path.basename(case_dir)}: dice per class "
              f"{[round(float(x), 3) for x in d]} "
              f"(NOT a quality claim at {args.steps} steps — geometry "
              f"rehearsal only)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
