"""Command line of the port, mirroring the repo's ``main.py``.

    python -m vnet_tpu_torch -p train --config_json CONFIG --device cuda
    python -m vnet_tpu_torch -p evaluate --config_json CONFIG --device cuda

``--device`` defaults to ``cuda`` and fails when there is no CUDA device;
the CPU runs only with ``--device cpu``. ``--gpu`` is accepted and ignored,
as in the JAX CLI; ``--devices`` takes 0 or 1 (one device; data parallelism
over more is not ported yet); ``--profile_dir DIR`` writes a
``torch.profiler`` trace of the phase into DIR (``profiler.TraceCapture``).
``main`` returns the final ``TrainState`` (train) or the written label paths
(evaluate).
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch",
        description="V-Net segmentation, PyTorch/CUDA port")
    parser.add_argument(
        "-v", "--verbose", dest="verbose", action="store_true",
        help="print the resolved device and configuration")
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
    parser.add_argument(
        "--gpu", dest="gpu", default="",
        help="accepted for reference compatibility; ignored (use --device)")
    parser.add_argument(
        "--devices", dest="devices", type=int, default=0,
        help="number of devices (0 or 1; more is not ported yet)")
    parser.add_argument(
        "--profile_dir", dest="profile_dir", default="",
        help="write a torch.profiler trace of the phase into this directory")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: data parallelism over several "
            "devices is not ported yet (ROADMAP.md); use 0 or 1")
    from .config import load_config
    from .device import resolve_device
    from .profiler import TraceCapture

    config = load_config(args.config_json)
    device = resolve_device(args.device)
    if args.verbose:
        print(f"device {device}; config {args.config_json}: {config}")
    profiler = None
    if args.profile_dir:
        profiler = TraceCapture(args.profile_dir, device)
        profiler.start()
    try:
        if args.phase == "train":
            from .train import Trainer

            return Trainer(config, device=device).train()
        from .infer.evaluator import Evaluator

        return Evaluator(config, device=device).evaluate()
    finally:
        if profiler is not None:
            profiler.stop()
            print(f"trace written to {profiler.path}")


if __name__ == "__main__":
    main()
