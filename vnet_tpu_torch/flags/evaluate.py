"""Legacy flag-driven evaluation CLI of the port — counterpart of the
repo's ``evaluate.py`` (the reference's stride_inplane/stride_layer flag
set), with the same flags and ``flags_to_config`` tree, parsed by the
port's ``config.py``. The network comes from the checkpoint directory's
``network_config.json`` and its newest ``ckpt_<step>.pt``
(``EvaluationSetting.CheckpointPath``), evaluated by the port's
``Evaluator`` on ``--device`` (default ``cuda``; ``cpu`` only when asked).

    python -m vnet_tpu_torch.flags.evaluate --data_dir ./data/evaluate \
        --checkpoint_path ./tmp/ckpt --patch_size 64 --patch_layer 64 \
        --stride_inplane 32 --stride_layer 32
"""

from __future__ import annotations

import argparse
import os


def get_parser():
    p = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.flags.evaluate",
        description="legacy flag-style evaluation")
    p.add_argument("--data_dir", default="./data/evaluate")
    p.add_argument("--image_filename", default="image.nii")
    p.add_argument("--label_filename", default="label_prob.nii.gz")
    p.add_argument("--checkpoint_path", default="./tmp/ckpt",
                   help="checkpoint directory to restore")
    p.add_argument("--patch_size", type=int, default=192)
    p.add_argument("--patch_layer", type=int, default=16)
    p.add_argument("--stride_inplane", type=int, default=144)
    p.add_argument("--stride_layer", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--attention", action="store_true")
    p.add_argument("--probability_output", action="store_true")
    p.add_argument("--gaussian_blend", action="store_true")
    p.add_argument("--volume_threshold", type=float, default=0.0,
                   help="drop connected components below this physical "
                        "volume; also masks the probability map outside "
                        "(reference evaluate.py:316-323)")
    p.add_argument("--label_mode", default="average_hard",
                   choices=["average_hard", "argmax"],
                   help="average_hard = legacy hard-prediction averaging "
                        "(evaluate.py:264-271); argmax = modern softmax "
                        "blend (model.py:934)")
    p.add_argument("--pipeline", default="")
    p.add_argument("--eval_norm", default="network",
                   choices=["network", "ema", "batch_stats"],
                   help="BN statistics source at inference: 'network' = "
                        "the checkpoint sidecar's Norm kind (legacy "
                        "parity: attention -> EMA per evaluate.py:249-251,"
                        " plain -> batch stats per :255); 'ema' / "
                        "'batch_stats' force one source for dual-mode "
                        "eval without editing the sidecar")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:N or cpu)")
    return p


def flags_to_config(args):
    """Assemble the Config from legacy flags + the checkpoint sidecar
    (testable seam mirroring ``train.flags_to_config``)."""
    from ..config import parse_config

    pipeline = args.pipeline
    if not pipeline:
        import tempfile
        import yaml
        patch = [args.patch_size, args.patch_size, args.patch_layer]
        fd, pipeline = tempfile.mkstemp(suffix=".yaml")
        with os.fdopen(fd, "w") as f:
            yaml.safe_dump({"preprocess": {
                "train": {"3D": None}, "test": {"3D": None},
                "evaluate": {"3D": [
                    {"name": "Padding", "variables": {"output_size": patch}},
                ]}}}, f)

    # the reference's evaluator restored the full meta-graph, so the
    # architecture traveled with the checkpoint (`model.py:1138-1139`);
    # this CLI has no network flags (parity with evaluate.py:20-41), so
    # read the Trainer's network_config.json sidecar when present
    networks = {"Name": "VNet", "Attention": args.attention}
    classes = [0, 1]
    precision = "float32"
    sidecar_path = os.path.join(args.checkpoint_path, "network_config.json")
    if os.path.isfile(sidecar_path):
        import json
        with open(sidecar_path) as f:
            sidecar = json.load(f)
        networks = dict(sidecar.get("Networks", networks))
        networks["Attention"] = bool(networks.get("Attention", False)
                                     or args.attention)
        classes = sidecar.get("SegmentationClasses", classes)
        precision = sidecar.get("Precision", precision)
    # legacy-path BN parity: the reference's attention evaluator feeds
    # train_phase=False (EMA eval, evaluate.py:249-251) while the plain
    # VNet path feeds True (batch stats, evaluate.py:255)
    if networks.get("Attention") and "Norm" not in networks:
        networks["Norm"] = "batch"

    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": args.data_dir,
                     "TestingDataDirectory": args.data_dir,
                     "ImageFilenames": [args.image_filename],
                     "LabelFilename": "label.nii"},
            "SegmentationClasses": classes,
            "PatchShape": [args.patch_size, args.patch_size,
                           args.patch_layer],
            "Precision": precision,
            "Networks": networks,
            "Pipeline": pipeline,
        },
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": args.data_dir,
                     "ImageFilenames": [args.image_filename],
                     "LabelFilename": args.label_filename,
                     "ProbabilityFilename": "probability.nii.gz"},
            "CheckpointPath": args.checkpoint_path,
            "Stride": [args.stride_inplane, args.stride_inplane,
                       args.stride_layer],
            "BatchSize": args.batch_size,
            "ProbabilityOutput": args.probability_output,
            "GaussianBlend": args.gaussian_blend,
            "VolumeThreshold": args.volume_threshold,
            "LabelMode": args.label_mode,
            "EvalNorm": getattr(args, "eval_norm", "network"),
            # the reference's legacy evaluator always masks the prob map
            # with the thresholded label when VolumeThreshold > 0
            "MaskProbabilityWithLabel": True,
            "Pipeline": pipeline,
        },
    }
    return parse_config(tree)


def main(argv=None):
    """Evaluate from the flags; returns the written label paths."""
    args = get_parser().parse_args(argv)
    config = flags_to_config(args)
    from ..infer import Evaluator
    return Evaluator(config, device=args.device).evaluate()


if __name__ == "__main__":
    main()
