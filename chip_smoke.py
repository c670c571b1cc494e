"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero before the result line:

1. device and build: card name, ``nvidia-smi`` name and power limit,
   whether PyYAML imports, the blend kernel's build time;
2. blend kernel vs its plain PyTorch version on the card, at the slice's
   shapes (10 contributions of (256, 256, 32, 4) f32 into a (384, 384, 64, 4)
   accumulator, starts overlapping on every axis) and at a ragged geometry
   (odd extents, clamped starts): results must be bitwise equal (same adds
   in the same order); both timed with CUDA events, median of 25;
3. the full-width VNet forward of one (1, 256, 256, 32, 1) patch in f32 with
   TF32 off, on the card vs the same module on the CPU;
4. the main path: two synthetic 384x384x64 cases evaluated through
   ``python -m vnet_tpu_torch``'s ``main`` on ``cuda`` at the slice config
   (``configs/config_eval_gaussian.json``: 16 channels, 4 levels, bf16,
   patch 256x256x32, stride 128x128x16, batch 10, cosine blend, LCC, volume
   threshold 50) with random weights from a seeded generator; the blend
   kernel's launches must equal the number of patch batches, outputs must
   exist, labels lie in {0, 1, 2}, probability maps are finite and agree
   with the plain slice-add blend (``BlendImpl: xla``) on the card.

The last lines are a JSON object describing each kernel, the card's name
and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EVAL_CONFIG = os.path.join(ROOT, "configs", "config_eval_gaussian.json")
SLICE_VOLUME = (384, 384, 64)
SLICE_PATCH = (256, 256, 32)
SLICE_STRIDE = (128, 128, 16)
SLICE_BATCH = 10
SEED = 0
# phase 3: f32 on the card (TF32 off) vs f32 on the CPU differ only by
# summation order; allowed max |diff| relative to the largest CPU logit
FORWARD_RTOL = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device_and_build():
    from vnet_tpu_torch.ops import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    try:
        import yaml  # noqa: F401  (the pipeline YAML loader needs it)
        has_yaml = True
    except ImportError:
        has_yaml = False
    say(f"[1] device: {name}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    say(f"[1] nvidia-smi: {smi}")
    say(f"[1] yaml imports: {has_yaml}")
    t0 = time.perf_counter()
    built = build.load("blend_accumulate")
    wall = time.perf_counter() - t0
    say(f"[1] blend kernel build: compiled={built.compiled} nvcc "
        f"{built.seconds:.2f} s, load {wall:.2f} s ({built.path.name})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[1] ptxas: {line.strip()}")
    check(has_yaml, "PyYAML is needed to read the pipeline YAML")
    return name, smi


def _kernel_vs_plain(acc_shape, patch, starts, gen, label):
    from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                          blend_accumulate_plain)

    dev = torch.device("cuda", 0)
    b = starts.shape[0]
    acc0 = torch.rand(acc_shape, generator=gen, device=dev)
    contrib = torch.rand((b,) + tuple(patch) + (acc_shape[-1],),
                         generator=gen, device=dev)
    st = torch.from_numpy(np.ascontiguousarray(starts, np.int32))
    out_k = blend_accumulate_patches(acc0.clone(), contrib, st)
    out_p = blend_accumulate_plain(acc0.clone(), contrib, st)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    equal = torch.equal(out_k, out_p)
    acc_k, acc_p = acc0.clone(), acc0.clone()
    ms = time_ms(lambda: blend_accumulate_patches(acc_k, contrib, st))
    plain_ms = time_ms(lambda: blend_accumulate_plain(acc_p, contrib, st))
    say(f"[2] {label}: acc {tuple(acc_shape)} contrib {tuple(contrib.shape)} "
        f"starts {starts.tolist()}")
    say(f"[2] {label}: bitwise_equal={equal} max_abs_err={err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms (median of 25)")
    check(equal, f"{label}: kernel differs from the plain version "
                 f"(max abs err {err})")
    return err, ms, plain_ms


def phase_kernel_vs_plain(card):
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, SLICE_STRIDE)
    check(len(grid) == 12, f"slice grid has {len(grid)} patches, expected 12")
    err, ms, plain_ms = _kernel_vs_plain(
        SLICE_VOLUME + (4,), SLICE_PATCH, grid[:SLICE_BATCH], gen,
        f"slice shapes on {card}")
    ragged_vol, ragged_patch = (97, 83, 45), (40, 33, 17)
    ragged = build_patch_grid(ragged_vol, ragged_patch, (23, 19, 11))
    err_r, _, _ = _kernel_vs_plain(ragged_vol + (3,), ragged_patch,
                                   ragged[-7:], gen, "ragged geometry")
    return max(err, err_r), ms, plain_ms


def phase_forward_card_vs_cpu():
    from vnet_tpu_torch.models import build_network, eval_apply

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    net = build_network("VNet", num_classes=3, norm="batch",
                        generator=gen)  # full width: 16 ch, 4 levels
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(1,) + SLICE_PATCH + (1,)).astype(np.float32))
    t0 = time.perf_counter()
    ref = eval_apply(net, x)
    cpu_s = time.perf_counter() - t0
    net.to("cuda")
    out = eval_apply(net, x.to("cuda")).cpu()
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    say(f"[3] forward f32 (1, 256, 256, 32, 1), TF32 off: max|cuda - cpu| = "
        f"{err:.3e}, max|cpu| = {scale:.3e}, tolerance "
        f"{FORWARD_RTOL:g} x max(1, max|cpu|); cpu {cpu_s:.1f} s")
    check(out.shape == (1,) + SLICE_PATCH + (3,), f"logits {out.shape}")
    check(bool(torch.isfinite(out).all()), "non-finite logits on the card")
    check(err <= FORWARD_RTOL * scale, "card forward disagrees with the CPU")


def _write_config(tmp):
    with open(EVAL_CONFIG) as f:
        cfg = json.load(f)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    ts["LogDir"] = os.path.join(tmp, "log")
    ts["CheckpointDir"] = es["CheckpointPath"] = os.path.join(tmp, "ckpt")
    ts["Pipeline"] = es["Pipeline"] = os.path.join(
        ROOT, "pipeline", "pipeline3D.yaml")
    es["Data"]["EvaluateDataDirectory"] = os.path.join(tmp, "evaluate")
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, cfg


def _synthetic_image(rng):
    """A 384x384x64 volume at 0.75 mm: noise around 100 (sigma 20) with one
    brighter and one darker sphere (+-12, radius 12 voxels)."""
    img = rng.normal(100.0, 20.0, size=SLICE_VOLUME).astype(np.float32)
    x, y, z = np.ogrid[tuple(slice(0, s) for s in SLICE_VOLUME)]
    for shift in (12.0, -12.0):
        cx, cy, cz = (int(rng.integers(16, s - 16)) for s in SLICE_VOLUME)
        img[(x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= 144] += shift
    return img


def phase_main_path(tmp):
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.infer.evaluator import Evaluator
    from vnet_tpu_torch.io import MedicalImage, read_image, write_image
    from vnet_tpu_torch.models import build_network
    from vnet_tpu_torch.ops.blend import blend_accumulate_patches
    from vnet_tpu_torch.train import checkpoints

    cfg_path, cfg = _write_config(tmp)
    ts = cfg["TrainingSetting"]
    rng = np.random.default_rng(SEED)
    cases = []
    for i in range(2):
        img = MedicalImage(_synthetic_image(rng), (0.75, 0.75, 0.75))
        case_dir = os.path.join(tmp, "evaluate", f"case_{i}")
        os.makedirs(case_dir)
        write_image(img, os.path.join(case_dir, "image.nii"))
        cases.append(case_dir)
    net_cfg = ts["Networks"]
    net = build_network(
        "VNet", num_classes=len(ts["SegmentationClasses"]),
        num_channels=net_cfg["NumChannel"], num_levels=net_cfg["NumLevels"],
        num_convolutions=net_cfg["NumConvolutions"],
        bottom_convolutions=net_cfg["BottomConvolutions"],
        norm=net_cfg["Norm"], generator=torch.Generator().manual_seed(SEED))
    checkpoints.save(ts["CheckpointDir"], net.state_dict(), 0)
    n_batches_per_case = -(-12 // SLICE_BATCH)

    blend_accumulate_patches.launches = 0
    t0 = time.perf_counter()
    results = main(["-p", "evaluate", "--config_json", cfg_path,
                    "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = blend_accumulate_patches.launches

    say(f"[4] main path: {len(results)} cases in {wall:.2f} s "
        f"({wall / 2:.2f} s per case incl. model build, checkpoint load and "
        f"first-call warm-up); blend launches {launches}, batches "
        f"{2 * n_batches_per_case}")
    check(len(results) == 2, f"{len(results)} labels written, expected 2")
    check(launches == 2 * n_batches_per_case,
          "blend kernel launches != patch batches")
    for case_dir in cases:
        label = read_image(os.path.join(case_dir, "label_tf.nii.gz"))
        check(label.GetSize() == SLICE_VOLUME, f"label {label.GetSize()}")
        values = set(np.unique(label.data).tolist())
        check(values <= {0, 1, 2}, f"label values {values}")
        for c in ts["SegmentationClasses"]:
            prob = read_image(os.path.join(case_dir,
                                           f"probability_tf_{c}.nii.gz"))
            check(prob.GetSize() == SLICE_VOLUME, f"prob {prob.GetSize()}")
            check(bool(np.isfinite(prob.data).all()), "non-finite prob map")
        say(f"[4] {os.path.basename(case_dir)}: label values "
            f"{sorted(values)}, {int(np.count_nonzero(label.data))} "
            f"foreground voxels, 3 finite probability maps")

    # steady state and the plain-blend reference, outside the counted run
    config = load_config(cfg_path)
    ev = Evaluator(config, device="cuda")
    ev.evaluate_case(cases[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    label_k, probs_k = ev.evaluate_case(cases[0])
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    config.evaluate.blend_impl = "xla"
    label_x, probs_x = Evaluator(config, device="cuda").evaluate_case(cases[0])
    agree = float(np.mean(label_k.data == label_x.data))
    prob_err = max(float(np.abs(a.data - b.data).max())
                   for a, b in zip(probs_k, probs_x))
    say(f"[4] steady state: {steady:.2f} s per case (host transforms, "
        f"forward, blend, resample, LCC); kernel vs plain blend end to end: "
        f"label agreement {agree:.6f}, max prob diff {prob_err:.3e}")
    check(agree >= 0.999, "kernel and plain blend labels disagree")
    # same blend arithmetic in the same order; the bound leaves room for
    # cuDNN choosing another bf16 algorithm for the second model instance
    check(prob_err <= 1e-3, "kernel and plain blend prob maps disagree")
    return launches, wall / 2, steady


def run():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke "
                 "run needs a CUDA card")
    import vnet_tpu_torch  # noqa: F401  (fails outside a checkout)

    card, smi = phase_device_and_build()
    err, ms, plain_ms = phase_kernel_vs_plain(card)
    phase_forward_card_vs_cpu()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_")
    try:
        launches, per_case, steady = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"kernels": [{
        "name": "blend_accumulate_patches", "route": "cuda",
        "source": "vnet_tpu_torch/csrc/blend_accumulate.cu",
        "replaces": "vnet_tpu/ops/pallas/fused.py:220",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    run()
