"""Command line of the port, mirroring the repo's ``main.py``.

    python -m vnet_tpu_torch -p train --config_json CONFIG --device cuda
    python -m vnet_tpu_torch -p evaluate --config_json CONFIG --device cuda

``--device`` defaults to ``cuda`` and fails when there is no CUDA device;
the CPU runs only with ``--device cpu``. ``main`` returns the final
``TrainState`` (train) or the written label paths (evaluate).
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch",
        description="V-Net segmentation, PyTorch/CUDA port")
    parser.add_argument(
        "-p", "--phase", dest="phase", default="train",
        choices=["train", "evaluate"],
        help="training phase or evaluation phase")
    parser.add_argument(
        "--config_json", dest="config_json", default="configs/config.json",
        metavar="FILENAME", help="JSON file for model configuration")
    parser.add_argument(
        "--device", dest="device", default="cuda",
        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    from .config import load_config

    config = load_config(args.config_json)
    if args.phase == "train":
        from .train import Trainer

        return Trainer(config, device=args.device).train()
    from .infer.evaluator import Evaluator

    return Evaluator(config, device=args.device).evaluate()


if __name__ == "__main__":
    main()
