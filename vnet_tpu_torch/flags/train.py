"""Legacy flag-driven training CLI of the port — counterpart of the repo's
``train.py`` (the reference's tf.app.flags set as argparse), with the same
flags and the same ``flags_to_config`` tree, parsed by the port's
``config.py`` and trained by the port's ``Trainer``. The attention-gated
variant is ``--attention``. ``--device`` (default ``cuda``; ``cpu`` only
when asked) takes the place of the JAX platform environment; training runs
in this process on that device (``python -m vnet_tpu_torch --devices N``
trains data-parallel). ``--remat`` sets ``Networks.Remat``: the network's
conv blocks (and the attention heads) are recomputed in the backward pass.

    python -m vnet_tpu_torch.flags.train --data_dir ./data --patch_size 64 \
        --patch_layer 64 --loss_function sorensen --optimizer adam --attention
"""

from __future__ import annotations

import argparse
import os

_OPTIMIZERS = {"sgd": "SGD", "adam": "Adam", "momentum": "Momentum",
               "nesterov_momentum": "NesterovMomentum"}


def get_parser():
    p = argparse.ArgumentParser(prog="python -m vnet_tpu_torch.flags.train",
                                description="legacy flag-style training")
    p.add_argument("--data_dir", default="./data",
                   help="directory of stored data (expects training/ and "
                        "testing/ subdirs, or case dirs directly)")
    p.add_argument("--image_filename", default="image.nii")
    p.add_argument("--label_filename", default="label.nii")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--patch_size", type=int, default=256,
                   help="in-plane size of a data patch")
    p.add_argument("--patch_layer", type=int, default=32,
                   help="number of layers in a data patch")
    p.add_argument("--epochs", type=int, default=999999999)
    p.add_argument("--log_dir", default="./tmp/log")
    p.add_argument("--init_learning_rate", type=float, default=1e-2)
    p.add_argument("--decay_factor", type=float, default=0.99)
    p.add_argument("--decay_steps", type=int, default=100)
    p.add_argument("--display_step", type=int, default=10)
    p.add_argument("--save_interval", type=int, default=1)
    p.add_argument("--checkpoint_dir", default="./tmp/ckpt")
    p.add_argument("--restore_training", action="store_true", default=True)
    p.add_argument("--no_restore_training", dest="restore_training",
                   action="store_false")
    p.add_argument("--drop_ratio", type=float, default=0.01)
    p.add_argument("--min_pixel", type=int, default=30)
    p.add_argument("--loss_function", default="sorensen",
                   choices=["xent", "weighted_xent", "sorensen", "jaccard",
                            "weighted_sorensen", "weighted_jaccard",
                            "mixed_sorensen", "mixed_jaccard",
                            "mixed_weighted_sorensen",
                            "mixed_weighted_jaccard"])
    p.add_argument("--attention_loss_function", default="l2",
                   choices=["l2", "abs"])
    p.add_argument("--optimizer", default="sgd", choices=sorted(_OPTIMIZERS))
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--attention", action="store_true")
    p.add_argument("--image_log", action="store_true")
    p.add_argument("--legacy_topology", action="store_true",
                   help="faithful legacy V-Net topology (VNet.py double "
                        "norm around residual adds) instead of the modern "
                        "networks.py block")
    p.add_argument("--pipeline", default="",
                   help="preprocessing pipeline YAML; a minimal "
                        "pad+random-crop pipeline is generated if empty")
    p.add_argument("--max_iterations", type=int, default=10 ** 9)
    p.add_argument("--dropout_impl", default="xla",
                   choices=["xla", "bits8", "pallas"],
                   help="dropout flavour (Networks.DropoutImpl); every "
                        "flavour runs the port's dropout kernel on the card")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize conv blocks (Networks.Remat): "
                        "recompute them in the backward pass, trading "
                        "step time for activation memory")
    p.add_argument("--cache_cases", type=int, default=0,
                   help="cache up to N loaded + deterministic-prefix-"
                        "transformed cases in the loader "
                        "(TrainingSetting.CacheCases)")
    p.add_argument("--device_augment", action="store_true",
                   help="run the RandomFlip/RandomNoise pipeline tail "
                        "on the device in the train step "
                        "(TrainingSetting.DeviceAugment) instead of "
                        "per-sample on the host")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p


def flags_to_config(args):
    from ..config import parse_config

    train_dir = args.data_dir
    test_dir = args.data_dir
    if os.path.isdir(os.path.join(args.data_dir, "training")):
        train_dir = os.path.join(args.data_dir, "training")
        test_dir = os.path.join(args.data_dir, "testing")

    pipeline = args.pipeline
    if not pipeline:
        import yaml
        patch = [args.patch_size, args.patch_size, args.patch_layer]
        section = {"3D": [
            {"name": "Padding", "variables": {"output_size": patch}},
            {"name": "RandomCrop",
             "variables": {"output_size": patch,
                           "drop_ratio": args.drop_ratio,
                           "min_pixel": args.min_pixel}},
        ]}
        # NOT under log_dir: Restore=False wipes log/ckpt dirs
        # (reference model.py:678-687) and would delete the pipeline
        # before the loader reads it
        import atexit
        import tempfile
        fd, pipeline = tempfile.mkstemp(prefix="pipeline_auto_",
                                        suffix=".yaml")
        os.close(fd)

        # the loader re-reads the file during training, so it must outlive
        # config parsing — clean up at interpreter exit instead of leaking
        # one temp file per invocation
        def _cleanup(p=pipeline):
            try:
                os.unlink(p)
            except OSError:
                pass

        atexit.register(_cleanup)
        with open(pipeline, "w") as f:
            yaml.safe_dump({"preprocess": {"train": section, "test": section,
                                           "evaluate": {"3D": section["3D"][:1]}}}, f)

    tree = {
        "TrainingSetting": {
            "Data": {
                "TrainingDataDirectory": train_dir,
                "TestingDataDirectory": test_dir,
                "ImageFilenames": [args.image_filename],
                "LabelFilename": args.label_filename,
            },
            "SegmentationClasses": [0, 1],
            "Restore": args.restore_training,
            "LogDir": args.log_dir,
            "CheckpointDir": args.checkpoint_dir,
            "BatchSize": args.batch_size,
            "PatchShape": [args.patch_size, args.patch_size,
                           args.patch_layer],
            "ImageLog": args.image_log,
            "Testing": args.testing,
            "TestStep": args.display_step,
            "Epoches": args.epochs,
            "MaxIterations": args.max_iterations,
            "LogInterval": args.display_step,
            # reference saves per-epoch (model.py:806-808); --save_interval
            # thins the epoch-end checkpoints when epochs are short and
            # checkpoint I/O would dominate wall-clock. The final state
            # always persists (MaxIterations abort save + final-epoch save
            # in the Trainer).
            "CheckpointEveryNEpochs": args.save_interval,
            "DropRatio": args.drop_ratio,
            "MinPixel": args.min_pixel,
            "CacheCases": args.cache_cases,
            "DeviceAugment": args.device_augment,
            "Networks": {"Name": ("VNetLegacy" if args.legacy_topology
                                  else "VNet"),
                         "Dropout": 0.01, "NumChannel": 16,
                         "NumLevels": 4, "NumConvolutions": [1, 2, 3, 3],
                         "BottomConvolutions": 3,
                         "Attention": args.attention,
                         "DropoutImpl": args.dropout_impl,
                         "Remat": args.remat,
                         # the reference's legacy ATTENTION evaluator feeds
                         # train_phase=False (EMA eval, evaluate.py:249-251)
                         # unlike every other inference path (batch stats,
                         # model.py:917 / evaluate.py:255); record that in
                         # the checkpoint sidecar so evaluation matches
                         **({"Norm": "batch"} if args.attention else {})},
            "Loss": {"Name": args.loss_function, "Weights": [], "Alpha": 1,
                     "AttentionKind": args.attention_loss_function},
            "Optimizer": {
                "Name": _OPTIMIZERS[args.optimizer],
                "InitialLearningRate": args.init_learning_rate,
                "Momentum": args.momentum,
                "Decay": {"Factor": args.decay_factor,
                          "Steps": args.decay_steps},
            },
            "Pipeline": pipeline,
        },
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": args.data_dir},
            "Stride": [args.patch_size, args.patch_size, args.patch_layer],
        },
    }
    return parse_config(tree)


def main(argv=None):
    """Train from the flags; returns the final ``TrainState``."""
    args = get_parser().parse_args(argv)
    config = flags_to_config(args)
    from ..train import Trainer
    return Trainer(config, device=args.device).train()


if __name__ == "__main__":
    main()
