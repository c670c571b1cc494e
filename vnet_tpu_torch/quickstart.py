"""Runnable end-to-end quickstart of the port: synthetic dataset -> train
-> evaluate — counterpart of the repo's ``scripts/quickstart.py``.

Generates the hard-synthetic 3-class dataset (irregular blobs, <=1%
foreground, heavy intensity overlap — ``utils/synthdata.py``, the same
cases from the same seed as the JAX package's generator), writes the same
config and pipeline as the JAX script for every mode, trains with the
port's ``Trainer`` (checkpoints, logs), evaluates the held-out cases with
the port's ``Evaluator`` (sliding window, header restore) and prints the
per-class Dice of each case:

    python -m vnet_tpu_torch.quickstart --workdir ./tmp/quickstart \
        --steps 6000 --seed 1337 --n-train 64 --augment --drop-ratio 0.3 \
        --min-pixel 32                      # the card, full width
    python -m vnet_tpu_torch.quickstart --device cpu --steps 4   # tiny CPU demo

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
only when asked, and implies ``--small`` unless ``--small`` is given.
``--rank2`` evaluates twice, with batch statistics and with the running
averages, and writes each mode's labels to its own file
(``pred_batch_stats.nii.gz``, ``pred_ema.nii.gz``), where the JAX script
writes both to ``pred.nii.gz``. The last line of the output is one JSON
object: the per-class Dice per case and evaluation mode, the steps run,
the median step (ms, from ``LogDir/train/scalars.jsonl``), the wall time
of data generation, training and each evaluation, and with
``--idle_window START COUNT`` on the card, the reading of a
``profiler.TraceCapture`` window over training steps START+1 to
START+COUNT: the device's busy time and idle share there, the window's
step beside the unprofiled step of the run (loader waits included in
both), and the idle share of the unprofiled step.

The generated ``<workdir>/config.json`` is a normal config: ``python -m
vnet_tpu_torch -p train --config_json <workdir>/config.json`` reproduces
the training.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import warnings

import numpy as np

from .utils.synthdata import dice_per_class, make_hard_dataset

# the label file of each evaluation mode of a --rank2 run
RANK2_MODES = {"batch_stats": "pred_batch_stats.nii.gz",
               "ema": "pred_ema.nii.gz"}


def build_dataset(workdir: str, shape, n_train: int, n_eval: int,
                  multimodal: bool = False, contrast: float = 0.6,
                  seed: int = 42):
    rng = np.random.default_rng(seed)
    kw = dict(shape=shape, multimodal=multimodal, contrast=contrast)
    make_hard_dataset(workdir, "training", n_train, rng, **kw)
    make_hard_dataset(workdir, "testing", max(1, n_train // 8), rng, **kw)
    make_hard_dataset(workdir, "evaluate", n_eval, rng, **kw)


def write_config(workdir: str, patch, steps: int, small: bool,
                 drop_ratio: float = 0.2, min_pixel: int = 8,
                 lr: float = 1e-3, augment: bool = False,
                 multimodal: bool = False, seed: int = 42) -> str:
    import yaml

    rank2 = len(patch) == 2
    if rank2:
        # 2D regime (reference NiftiDataset2D): the labeled-SLICE
        # inventory does the rare-class balancing (TrainingSetting
        # DropRatio/MinPixel below), so the 2D RandomCrop can keep mild
        # settings. The hard synthetic's intensities are N(100, 20)
        # x (1 +- 10% bias); window 40..160 = +-3 sigma
        # (no 2D StatisticalNormalization in the reference's registry).
        train_tfms2d = [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 40, "windowMax": 160}},
            {"name": "Padding", "variables": {"output_size": list(patch)}},
        ]
        if augment:
            # the reference's 2D training arsenal
            # (NiftiDataset2D.py:534-624): parameterless RandomFlip
            # (independent LR/UD, each p=0.5) + RandomRotate
            # (uniform [-90,90) deg) + RandomTranslate
            train_tfms2d.append({"name": "RandomFlip"})
            train_tfms2d.append({"name": "RandomRotate"})
            train_tfms2d.append({"name": "RandomTranslate",
                                 "variables": {"maxOffset": [10, 10]}})
        train_tfms2d.append(
            {"name": "RandomCrop",
             "variables": {"output_size": list(patch),
                           "drop_ratio": drop_ratio,
                           "min_pixel": min_pixel}})
        eval_tfms2d = [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 40, "windowMax": 160}},
            {"name": "Padding", "variables": {"output_size": list(patch)}},
        ]
        pipeline = {"preprocess": {
            "train": {"3D": [], "2D": train_tfms2d},
            "test": {"3D": [], "2D": eval_tfms2d + [
                {"name": "RandomCrop",
                 "variables": {"output_size": list(patch), "drop_ratio": 1.0,
                               "min_pixel": 0}}]},
            "evaluate": {"3D": [], "2D": eval_tfms2d},
        }}
    else:
        # augment=True adds the reference's standard training augmentations
        # (RandomFlip + RandomNoise, cf. pipeline/pipeline3D.yaml): the
        # quality2 diagnosis (BENCHMARKS.md "Quality") found an un-augmented
        # net brittle — individual grid patches collapse to noise predictions
        # while neighboring patches in the SAME batch segment at dice ~0.9.
        # Noise sigma 8 ~= 0.16 of the post-StatisticalNormalization noise
        # std (window maps mean+/-2.5 std -> 0..255, so 1 sigma ~= 51).
        train_tfms = [
            {"name": "StatisticalNormalization", "variables": {"sigma": 2.5}},
            {"name": "Padding", "variables": {"output_size": list(patch)}},
        ]
        if augment:
            train_tfms.append(
                {"name": "RandomFlip",
                 "variables": {"axes": [True, True, True]}})
        train_tfms.append(
            # drop_ratio = probability of ACCEPTING a crop with fewer than
            # min_pixel foreground voxels (reference NiftiDataset3D.py
            # RandomCrop semantics); at <=1% foreground, LOWERING it (with
            # a meaningful min_pixel) biases sampling toward patches the
            # rare classes actually appear in
            {"name": "RandomCrop",
             "variables": {"output_size": list(patch),
                           "drop_ratio": drop_ratio,
                           "min_pixel": min_pixel}})
        if augment:
            # after the crop: noise on the 64^3 patch, not the whole volume
            train_tfms.append(
                {"name": "RandomNoise", "variables": {"sigma": 8}})
        pipeline = {"preprocess": {
            "train": {"3D": train_tfms},
            "test": {"3D": [
                {"name": "StatisticalNormalization",
                 "variables": {"sigma": 2.5}},
                {"name": "Padding", "variables": {"output_size": list(patch)}},
                {"name": "RandomCrop",
                 "variables": {"output_size": list(patch), "drop_ratio": 1.0,
                               "min_pixel": 0}},
            ]},
            "evaluate": {"3D": [
                {"name": "StatisticalNormalization",
                 "variables": {"sigma": 2.5}},
                {"name": "Padding", "variables": {"output_size": list(patch)}},
            ]},
        }}
    ppath = os.path.join(workdir, "pipeline.yaml")
    with open(ppath, "w") as f:
        yaml.safe_dump(pipeline, f)

    net = ({"Name": "VNet", "Dropout": 0.0, "NumChannel": 4, "NumLevels": 2,
            "NumConvolutions": [1, 1], "BottomConvolutions": 1}
           if small else
           {"Name": "VNet", "Dropout": 0.01, "NumChannel": 16,
            "NumLevels": 4, "NumConvolutions": [1, 2, 3, 3],
            "BottomConvolutions": 3, "PackedTargetLanes": 128})
    # 3D augmentation runs on the device (data/device_aug.py): the trainer
    # takes RandomFlip/RandomNoise out of the host chain (identical math —
    # flip all axes together p=0.5, additive gaussian on the cropped
    # patch), leaving the host the cached statnorm prefix + RandomCrop.
    device_augment = bool(augment and not rank2)
    cfg = {
        "TrainingSetting": {
            "Seed": seed,
            "DeviceAugment": device_augment,
            "Data": {"TrainingDataDirectory": os.path.join(workdir, "training"),
                     "TestingDataDirectory": os.path.join(workdir, "testing"),
                     "ImageFilenames": (["image.nii", "image_t2.nii"]
                                        if multimodal else ["image.nii"]),
                     "LabelFilename": "label.nii"},
            "SegmentationClasses": [0, 1, 2],
            # rank-2: the slice inventory keeps slices whose smallest
            # per-class count exceeds MinPixel, else with prob DropRatio
            **({"DropRatio": drop_ratio, "MinPixel": min_pixel}
               if rank2 else {}),
            "BatchSize": (4 if small else 32) if rank2
            else (2 if small else 8),
            "PatchShape": list(patch),
            "Epoches": 10 ** 6,  # bounded by MaxIterations
            "MaxIterations": steps,
            "LogDir": os.path.join(workdir, "log"),
            "CheckpointDir": os.path.join(workdir, "ckpt"),
            "LogInterval": max(10, steps // 4),
            # epochs here are a few steps: thin the per-epoch saves
            # (the final state is still saved)
            "CheckpointEveryNEpochs": 20,
            "Precision": "float32" if small else "bfloat16",
            "CacheCases": 64,
            "Networks": net,
            "Loss": {"Name": "weighted_sorensen", "Weights": [0.01, 0.3, 1.0]},
            "Optimizer": {"Name": "Adam", "InitialLearningRate": lr,
                          "Decay": {"Factor": 0.99, "Steps": 100}},
            "Pipeline": ppath,
        },
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": os.path.join(workdir, "evaluate"),
                     "ImageFilenames": (["image.nii", "image_t2.nii"]
                                        if multimodal else ["image.nii"]),
                     "LabelFilename": "pred.nii.gz",
                     "ProbabilityOutput": False},
            "Stride": [max(8, p // 2) for p in patch],
            "BatchSize": 4,
            "Pipeline": ppath,
        },
    }
    cpath = os.path.join(workdir, "config.json")
    with open(cpath, "w") as f:
        json.dump(cfg, f, indent=2)
    return cpath


def _median_step_ms(log_dir: str):
    """The median of the trainer's logged step times (ms), or None."""
    path = os.path.join(log_dir, "train", "scalars.jsonl")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        times = [json.loads(line)["value"] for line in f
                 if '"perf/step_time_s"' in line]
    return statistics.median(times) * 1e3 if times else None


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.quickstart",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="./tmp/quickstart")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cpu implies "
                         "--small")
    ap.add_argument("--small", action="store_true", default=None,
                    help="tiny network/patches (default when --device cpu)")
    ap.add_argument("--drop-ratio", type=float, default=0.2,
                    help="RandomCrop probability of ACCEPTING a crop with "
                         "fewer than --min-pixel foreground voxels (lower "
                         "toward 0 to bias sampling onto the rare classes)")
    ap.add_argument("--min-pixel", type=int, default=8,
                    help="foreground-voxel threshold for --drop-ratio")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-train", type=int, default=None,
                    help="training cases to generate (default 8 small / "
                         "24 full)")
    ap.add_argument("--augment", action="store_true",
                    help="add RandomFlip + RandomNoise training "
                         "augmentation (reference pipeline3D.yaml style)")
    ap.add_argument("--rank2", action="store_true",
                    help="2D regime: train on labeled slices of the same "
                         "3D volumes, evaluate slice-stacked with batch "
                         "statistics and with the running averages, report "
                         "3D per-class Dice")
    ap.add_argument("--multimodal", action="store_true",
                    help="2-channel dataset (image.nii + image_t2.nii) "
                         "where each foreground class is separable in one "
                         "channel only")
    ap.add_argument("--seed", type=int, default=42,
                    help="dataset-generation AND training seed")
    ap.add_argument("--contrast", type=float, default=None,
                    help="lesion contrast in background-noise sigmas "
                         "(default 0.6; --rank2 defaults to 2.0)")
    ap.add_argument("--idle_window", type=int, nargs=2, default=None,
                    metavar=("START", "COUNT"),
                    help="profile the device over training steps START+1 "
                         "to START+COUNT and report its idle share, and "
                         "the run's unprofiled step")
    ap.add_argument("--loader_workers", type=int, default=None,
                    help="the config's LoaderWorkers (default 2): 1 draws "
                         "the crops in one order, run after run")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True) for the "
                         "run (set CUBLAS_WORKSPACE_CONFIG=:4096:8 too)")
    ap.add_argument("--eval_norms", nargs="+", default=None,
                    choices=sorted(RANK2_MODES),
                    help="3D: evaluate once per mode, each into its own "
                         "label files, as --rank2 does (default: the "
                         "config's EvalNorm)")
    return ap


def main(argv=None) -> dict:
    """Generate, train, evaluate; returns the result the last line prints."""
    args = get_parser().parse_args(argv)
    from .device import resolve_device

    resolve_device(args.device)  # no card: fail before generating data
    small = args.small if args.small is not None else (
        args.device == "cpu")
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    shape = (48, 48, 32) if small else (96, 96, 64)
    if args.rank2:
        patch = (48, 48) if small else (96, 96)  # whole-slice patches
    else:
        patch = (32, 32, 32) if small else (64, 64, 64)

    contrast = args.contrast if args.contrast is not None else (
        2.0 if args.rank2 else 0.6)
    meta_path = os.path.join(workdir, "dataset_meta.json")
    meta = {"contrast": contrast, "seed": args.seed, "shape": list(shape),
            "multimodal": bool(args.multimodal),
            "n_train": args.n_train or (8 if small else 24)}
    wall = {}
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(workdir, "training")):
        print(f"generating synthetic dataset under {workdir} "
              f"(contrast {contrast} sigma) ...", flush=True)
        build_dataset(workdir, shape, n_train=meta["n_train"],
                      n_eval=2 if small else 4,
                      multimodal=args.multimodal, contrast=contrast,
                      seed=args.seed)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    elif os.path.isfile(meta_path):
        # generation is skipped on reuse: the knobs that shape the data
        # must match what the workdir was generated with
        with open(meta_path) as f:
            old = json.load(f)
        if old != meta:
            raise SystemExit(
                f"{workdir} holds a dataset generated with {old}, but "
                f"this invocation asks for {meta}; use a fresh --workdir "
                f"(or delete the old one) — generation is skipped on "
                f"reuse and the data would not match the recipe")
    else:
        warnings.warn(
            f"reusing pre-existing dataset in {workdir} with no "
            f"dataset_meta.json — cannot verify it matches "
            f"contrast={contrast}/seed={args.seed}", stacklevel=1)
    wall["data_s"] = time.perf_counter() - t0
    cpath = write_config(workdir, patch, args.steps, small,
                         drop_ratio=args.drop_ratio,
                         min_pixel=args.min_pixel, lr=args.lr,
                         augment=args.augment,
                         multimodal=args.multimodal, seed=args.seed)
    if args.loader_workers is not None:
        with open(cpath) as f:
            written = json.load(f)
        written["TrainingSetting"]["LoaderWorkers"] = args.loader_workers
        with open(cpath, "w") as f:
            json.dump(written, f, indent=2)
    if args.deterministic:
        import torch

        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    print(f"config written: {cpath}", flush=True)

    from .config import load_config
    from .infer import Evaluator
    from .io import read_image
    from .profiler import TraceCapture
    from .train import Trainer

    cfg = load_config(cpath)
    t0 = time.perf_counter()
    window = (TraceCapture(None, args.device, steps=tuple(args.idle_window))
              if args.idle_window else None)
    trainer = Trainer(cfg, device=args.device, trace=window)
    state = trainer.train()
    wall["train_s"] = time.perf_counter() - t0
    print(f"training done: {state.step} steps", flush=True)
    state_dict = state.network.state_dict()

    def run_eval(cfg, tag):
        t0 = time.perf_counter()
        results = Evaluator(cfg, state_dict=state_dict,
                            device=args.device).evaluate()
        wall[f"evaluate_{tag}_s"] = time.perf_counter() - t0
        print(f"evaluated {len(results)} case(s) [{tag}]", flush=True)
        scores = {}
        for pred_path in results:
            case_dir = os.path.dirname(pred_path)
            truth = np.asarray(
                read_image(os.path.join(case_dir, "label.nii")).data)
            pred = np.asarray(read_image(pred_path).data)
            d = [float(x) for x in dice_per_class(pred, truth, 3)]
            scores[os.path.basename(case_dir)] = d
            print(f"{os.path.basename(case_dir)} [{tag}]: dice per class "
                  f"{[round(x, 3) for x in d]}", flush=True)
        return scores

    dice = {}
    modes = args.eval_norms or (list(RANK2_MODES) if args.rank2 else None)
    if modes:
        # 2D slice-stacked evaluation depends on the batch-norm statistics'
        # source: report both, each mode into its own label files
        for mode in modes:
            e = dataclasses.replace(cfg.evaluate, eval_norm=mode,
                                    label_filename=RANK2_MODES[mode])
            dice[mode] = run_eval(dataclasses.replace(cfg, evaluate=e), mode)
    else:
        dice[cfg.evaluate.eval_norm] = run_eval(cfg, cfg.evaluate.eval_norm)
    result = {"quickstart": {
        "mode": "2d" if args.rank2 else "3d", "device": str(trainer.device),
        "steps": state.step, "batch": cfg.train.batch_size,
        "patch": list(patch), "dice": dice,
        "median_step_ms": _median_step_ms(cfg.train.log_dir),
        "idle": None if window is None else window.reading, "wall": wall}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
