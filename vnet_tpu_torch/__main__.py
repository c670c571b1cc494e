"""Command line of the port, mirroring the repo's ``main.py``.

    python -m vnet_tpu_torch -p train --config_json CONFIG --device cuda
    python -m vnet_tpu_torch -p evaluate --config_json CONFIG --device cuda

``--device`` defaults to ``cuda`` and fails when there is no CUDA device;
the CPU runs only with ``--device cpu``. ``--devices N`` behaves as the
JAX CLI's: 0 (the default) uses every visible card, and N > 0 sets
``Mesh.DataParallel``. The phase runs data-parallel in a process group, one
process a card (``parallel/mesh.py::launch``): training on ``gcd(BatchSize,
cards)`` ranks for 0, else N; evaluation on every card for 0, else N. Above
one rank the CLI spawns its local ranks itself; under torchrun (``RANK``,
``WORLD_SIZE`` set, several nodes) each process joins the group torchrun
describes. CUDA runs under ``nccl``, the CPU under ``gloo``; a run on one
card is a group of one rank, which launches no collective; ``--device
cpu`` with ``--devices`` 0 or 1 runs one process without a group. Asking
for more cards than torch sees raises: nothing falls back to fewer cards
or to the CPU. ``--gpu`` is accepted and ignored, as in the JAX CLI;
``--profile_dir DIR`` writes a ``torch.profiler`` trace of rank 0's phase
into DIR (``profiler.TraceCapture``). ``main`` returns the final
``TrainState`` (train) or the written label paths (evaluate) when the
phase ran in this process, None when it ran in spawned ranks.
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
        help="number of devices for the data-parallel mesh (0 = all)")
    parser.add_argument(
        "--profile_dir", dest="profile_dir", default="",
        help="write a torch.profiler trace of the phase into this directory")
    return parser


def _run(args):
    """The phase on this rank (or in this process without a group)."""
    import torch.distributed as dist

    from .config import load_config
    from .profiler import TraceCapture

    config = load_config(args.config_json)
    if args.devices:  # the ranks form the (data, space) grid
        config.train.mesh_data_parallel = args.devices // max(
            int(config.train.mesh_space_parallel), 1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.verbose and rank == 0:
        world = dist.get_world_size() if dist.is_initialized() else 1
        backend = dist.get_backend() if dist.is_initialized() else "none"
        print(f"device {args.device}; {world} rank(s), process group "
              f"{backend}; config {args.config_json}: {config}")
    profiler = None
    if args.profile_dir and rank == 0:
        from .device import resolve_device

        profiler = TraceCapture(args.profile_dir, resolve_device(args.device))
        profiler.start()
    try:
        if args.phase == "train":
            from .train import Trainer

            return Trainer(config, device=args.device).train()
        from .infer.evaluator import Evaluator

        return Evaluator(config, device=args.device).evaluate()
    finally:
        if profiler is not None:
            profiler.stop()
            print(f"trace written to {profiler.path}")


def _ranks(args, t) -> int:
    """Local ranks to launch for the training settings ``t``:
    ``--devices``, or for 0 one CPU process and, on the cards, every card
    (evaluation) or the trainer's ``(data, space)`` grid (training)."""
    import torch

    from .device import resolve_device
    from .parallel.mesh import data_parallel_size

    device = resolve_device(args.device)
    if args.devices < 0:
        raise ValueError(f"--devices must be >= 0, got {args.devices}")
    if device.type != "cuda":
        return max(args.devices, 1)
    if device.index is not None:  # one card named
        if args.devices > 1:
            raise ValueError(f"--devices {args.devices} puts rank r on card "
                             f"r: pass --device cuda, not {args.device}")
        return 1
    cards = torch.cuda.device_count()
    if args.devices or args.phase != "train":
        want, source = args.devices or cards, "--devices"
    elif t.mesh_dcn_parallel > 1:
        # JAX's multi-slice mesh takes every device: here the node's cards
        want = t.mesh_data_parallel or cards
        source = "Mesh.DataParallel"
    else:
        space = max(int(t.mesh_space_parallel), 1)
        want = space * data_parallel_size(t.batch_size, t.mesh_data_parallel,
                                          cards // space)
        source = ("Mesh.DataParallel" if space == 1
                  else f"Mesh.DataParallel x SpaceParallel {space}:")
    if want > cards:
        raise ValueError(f"{source} {want} needs {want} cards, torch sees "
                         f"{cards}")
    return want


def main(argv=None):
    args = get_parser().parse_args(argv)
    import torch

    from .config import load_config
    from .parallel.mesh import launch, under_torchrun

    t = load_config(args.config_json).train
    batch = t.batch_size
    ranks = _ranks(args, t)
    data = ranks // max(int(t.mesh_space_parallel), 1)
    if args.phase == "train" and data and batch % data:
        raise ValueError(f"--devices {ranks}: a batch of {batch} does not "
                         f"split over {data} data-parallel ranks")
    if (torch.device(args.device).type == "cpu" and ranks == 1
            and not under_torchrun()):
        return _run(args)
    return launch(_run, ranks, device=args.device, args=(args,))


if __name__ == "__main__":
    main()
