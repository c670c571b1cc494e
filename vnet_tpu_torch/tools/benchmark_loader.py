"""Input-pipeline sustained rate: can the host feed the card?

    python -m vnet_tpu_torch.tools.benchmark_loader [--cases 8]
        [--size 192 192 96] [--patch 64] [--batch 8] [--workers N]
        [--backend process|thread] [--batches 20]
        [--variant full|lean|cached|confidence|both] [--data_dir DIR]

The port's counterpart of ``scripts/benchmark_loader.py``, on the host
only: the port's ``BatchLoader`` over its ``NiftiDataset3D`` and 3D
transforms, end to end (NIfTI decode, the transform chain, random crop,
batch assembly), in patches/s, beside the training step's rate on the
card. The variants are the JAX script's:

  full       — StatisticalNormalization, Resample, Padding, RandomCrop,
               RandomNoise (the production-shaped chain);
  lean       — decode, normalize and crop only; flip and noise run on the
               card (``data/device_aug.py``);
  cached     — full with ``cache_cases``: decode and the deterministic
               prefix memoized a case;
  confidence — the reference production sampler, ConfidenceCrop2 with its
               jitter scaled to the patch, cached.

``make_cases`` writes the JAX script's gzip'd cases byte for byte from the
same generator (seed 0) into a temporary directory, removed at the end;
``--data_dir`` reuses a case directory instead. One JSON line a variant,
with the JAX script's keys; ``host_cpus`` is the host's CPU count, the
default ``--workers``. Each run closes its loader, so the ``process``
backend's workers end with it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from ..data import transforms3d as T
from ..data.dataset3d import NiftiDataset3D
from ..data.loader import BatchLoader
from ..io.nifti import MedicalImage, write_image

VARIANTS = ("full", "lean", "cached", "confidence")


def make_cases(root: str, n_cases: int, size, rng) -> str:
    """Synthetic .nii.gz cases with a bright-blob label (gzip keeps the
    decode cost realistic); returns the case directory."""
    data_dir = os.path.join(root, "training")
    for i in range(n_cases):
        case = os.path.join(data_dir, f"case_{i}")
        os.makedirs(case, exist_ok=True)
        img = rng.normal(60.0, 25.0, size=size).astype(np.float32)
        lbl = np.zeros(size, np.uint8)
        c = [rng.integers(s // 4, 3 * s // 4) for s in size]
        r = max(4, min(size) // 6)
        zz, yy, xx = np.ogrid[:size[0], :size[1], :size[2]]
        sphere = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                  + (xx - c[2]) ** 2) <= r * r
        lbl[sphere] = 1
        img[sphere] += 60.0
        write_image(MedicalImage(img, (0.75, 0.75, 0.75)),
                    os.path.join(case, "image.nii.gz"))
        write_image(MedicalImage(lbl, (0.75, 0.75, 0.75)),
                    os.path.join(case, "label.nii.gz"))
    return data_dir


def build_dataset(data_dir: str, patch: int, variant: str,
                  cache_cases: int = 0) -> NiftiDataset3D:
    tfms = [
        T.StatisticalNormalization(2.5),
        T.Resample((0.75, 0.75, 0.75)),
        T.Padding([patch] * 3),
    ]
    if variant == "confidence":
        # the reference production pipeline's sampler, jitter scaled to
        # the patch size (pipeline3D.yaml: ConfidenceCrop2 rand 32 p 0.8
        # at 128^3 -> rand 16 at the default 64^3)
        tfms.append(T.ConfidenceCrop2([patch] * 3, rand_range=patch // 4,
                                      probability=0.8))
    else:
        tfms.append(T.RandomCrop([patch] * 3, drop_ratio=0.1, min_pixel=10))
    if variant in ("full", "confidence"):
        tfms.append(T.RandomNoise())
    return NiftiDataset3D(
        data_dir, ["image.nii.gz"], "label.nii.gz", transforms=tfms,
        train=True, labels=[0, 1], cache_cases=cache_cases)


def run(variant: str, args, data_dir: str) -> dict:
    """One variant's sustained rate over ``args.batches`` batches, after
    one warm batch (worker start-up and the page cache)."""
    base = {"cached": "full", "confidence": "confidence"}.get(variant, variant)
    ds = build_dataset(data_dir, args.patch, base,
                       cache_cases=(args.cases
                                    if variant in ("cached", "confidence")
                                    else 0))
    if len(ds) < args.batch:
        raise SystemExit(f"{len(ds)} cases make no batch of {args.batch}: "
                         f"an epoch drops its last partial batch")
    loader = BatchLoader(ds, batch_size=args.batch, shuffle=True,
                         num_workers=args.workers, backend=args.backend,
                         prefetch=2 * args.batch, seed=0)
    it = iter(loader.epoch())
    try:
        next(it)
        t0 = time.perf_counter()
        produced = 0
        while produced < args.batches:
            try:
                next(it)
            except StopIteration:
                it = iter(loader.epoch())
                continue
            produced += 1
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return {
        "variant": variant,
        "patches_per_s": produced * args.batch / dt,
        "sec_per_batch": dt / produced,
        "workers": args.workers,
        "backend": args.backend,
        "batch": args.batch,
        "patch": args.patch,
        "cases": args.cases,
        "case_size": list(args.size),
        "host_cpus": os.cpu_count(),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=3, default=[192, 192, 96])
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--backend", default="process",
                    choices=["thread", "process"])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--variant", default="both",
                    choices=list(VARIANTS) + ["both"])
    ap.add_argument("--data_dir", default="",
                    help="reuse an existing case dir instead of generating")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    tmp = None
    data_dir = args.data_dir
    if not data_dir:
        tmp = tempfile.mkdtemp(prefix="loaderbench_")
        data_dir = make_cases(tmp, args.cases, tuple(args.size),
                              np.random.default_rng(0))
    variants = VARIANTS if args.variant == "both" else (args.variant,)
    try:
        results = []
        for v in variants:
            results.append(run(v, args, data_dir))
            print(json.dumps(results[-1]), flush=True)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
