"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero before the result line:

1. device and build: card name, ``nvidia-smi`` name and power limit,
   whether PyYAML and tensorboardX import; the six kernel sources (blend,
   dropout, dW, BN statistics, fused tail, row blend) built from source in
   parallel, one ``nvcc`` each, with their build times and ptxas registers
   and spills;
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
   with the plain slice-add blend (``BlendImpl: xla``) on the card;
5. dropout kernel vs its plain version at (96, 16, 64, 64, 64) bf16
   channels-last, the main path's largest dropout, for ``pallas`` and
   ``bits8`` at the config's rate 0.01: bitwise equal, keep fraction within
   5 sigma, backward mask = forward mask for a gradient that is not
   channels-last; kernel, plain and ``F.dropout`` times;
6. dW kernel vs its plain version at the main path's shapes, batch 96 bf16
   (16->16 and 32->16 5^3 at 64^3, 128->128 at 8^3, 256->256 at 4^3, the
   1^3 16->3 output conv): max |diff| <= DW_RTOL * max |dW|; kernel, plain
   and cuDNN weight-gradient times;
7. the training main path: ``python -m vnet_tpu_torch -p train``'s
   ``main`` on ``cuda`` at ``configs/config.json``'s network (16 channels,
   4 levels, PReLU, batch norm, dropout 0.01, weighted Sorensen, Adam,
   bf16) with patch 64^3, ``DropoutImpl``/``DwImpl`` ``pallas``, batch 4,
   4 steps, on 8 synthetic 96x96x80 cases; finite losses, launch counts of
   the module tree (21 dropout layers forward and backward, 22 stride-1
   convolutions, per step), a checkpoint that restores;
8. the training step at ``bench.py``'s flagship workload (batch 96, 64^3,
   random data; the port runs direct convolutions, ``bench.py`` the JAX
   model's packed ones) through ``make_train_step``: median step time,
   patches/s and peak memory, with the kernels and with ``xla`` dropout
   and dW;
9. BatchNorm statistics kernels (``bn_stats``, ``bn_grad_stats``) vs their
   plain versions in bf16 at the flagship step's BN inputs, batch 96
   ((64^3, 16), (32^3, 32), (8^3, 128), the (64^3, 3) output norm, and the
   packed (32^3, 128) layout of groups 8), x of mean 1 and dy correlated
   with x: per channel within ``BN_RTOL * sum|terms|``, and bitwise equal
   from run to run (a launch count is one call of the kernels' entry point,
   a pair of kernels: partials, then their reduction); then
   ``ops/batchnorm.py::batch_norm_train`` forward and backward with
   ``STATS_IMPL`` ``pallas`` vs ``xla``, and vs autograd of
   ``models.layers.BatchNorm`` at groups 1; kernel, plain and
   ``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce`` times;
10. the fused bias + PReLU + residual tail vs its plain version at
   (96, 64, 64, 64, 16) bf16 and at a ragged, unaligned f32 shape with
   C = 3, bias and slope in x's dtype: bitwise equal, one launch per
   checked call; kernel and plain times;
11. the row blend vs its plain loop over segments at the evaluation slice's
   geometry flattened (the z-lines of the first batch of 10 patches, 655360
   segments of 32 rows, the cosine window's z-profile) and at a ragged
   geometry: bitwise equal, one launch per overlap level (the count and a
   ``torch.profiler`` trace agree); the kernels' device time from the
   trace, the host levelling, the whole call and the plain loop timed.

No entry point reaches the kernels of phases 9-11 (as in the JAX package);
their launches in the ``kernels`` line are the counts of their own phase.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EVAL_CONFIG = os.path.join(ROOT, "configs", "config_eval_gaussian.json")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "config.json")
KERNELS = ("blend_accumulate", "dropout", "dw_conv", "bn_stats",
           "bias_prelu_residual", "blend_rows")
SLICE_VOLUME = (384, 384, 64)
SLICE_PATCH = (256, 256, 32)
SLICE_STRIDE = (128, 128, 16)
SLICE_BATCH = 10
SEED = 0
# phase 3: f32 on the card (TF32 off) vs f32 on the CPU differ only by
# summation order; allowed max |diff| relative to the largest CPU logit
FORWARD_RTOL = 1e-3
# phase 6: float32 sums of bf16 products (exact in float32) over up to 25M
# positions, in another order than the plain version's; allowed max |diff|
# relative to max |dW|
DW_RTOL = 1e-4
# phase 9: float32 sums over up to 25M rows in another order than the plain
# version's; allowed |diff| per channel relative to the sum of |terms|
BN_RTOL = 1e-5
# phase 9: batch_norm_train's gradients, allowed max |diff| relative to the
# reference's max |grad| (float32 sums of bf16 data in other orders; dx is
# bf16, so one bf16 ulp of each element comes on top)
BN_GRAD_RTOL = 1e-3
BF16_ULP = 2.0 ** -7  # bf16 spacing relative to a value's binade
# H100 SXM datasheet peaks: HBM bytes/s, bf16 dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TRAIN_PATCH = (64, 64, 64)
TRAIN_CASE = (96, 96, 80)
FLAGSHIP_BATCH = 96


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = 25, warmup: bool = True) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call
    unless the caller has just made one."""
    if warmup:
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
    has = {}
    for module in ("yaml", "tensorboardX"):
        try:
            __import__(module)
            has[module] = True
        except ImportError:
            has[module] = False
    say(f"[1] device: {name}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    say(f"[1] nvidia-smi: {smi}")
    say(f"[1] yaml imports: {has['yaml']}; tensorboardX imports: "
        f"{has['tensorboardX']} (the port logs scalars as JSON lines)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        built = list(pool.map(build.load, KERNELS))
    say(f"[1] kernel builds in parallel: {time.perf_counter() - t0:.2f} s")
    for kernel, b in zip(KERNELS, built):
        say(f"[1] {kernel} build: compiled={b.compiled} nvcc "
            f"{b.seconds:.2f} s ({b.path.name})")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[1] {kernel} ptxas: {line.strip()}")
    check(has["yaml"], "PyYAML is needed to read the pipeline YAML")
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
    # bytes: acc read and written once, every contribution read once
    bound_ms = (2 * acc0.nbytes + contrib.nbytes) / HBM_BYTES_PER_S * 1e3
    say(f"[2] {label}: bitwise_equal={equal} max_abs_err={err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms (median of 25); "
        f"byte bound {bound_ms:.4f} ms")
    check(equal, f"{label}: kernel differs from the plain version "
                 f"(max abs err {err})")
    return err, ms, plain_ms, bound_ms


def phase_kernel_vs_plain(card):
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, SLICE_STRIDE)
    check(len(grid) == 12, f"slice grid has {len(grid)} patches, expected 12")
    err, ms, plain_ms, bound_ms = _kernel_vs_plain(
        SLICE_VOLUME + (4,), SLICE_PATCH, grid[:SLICE_BATCH], gen,
        f"slice shapes on {card}")
    ragged_vol, ragged_patch = (97, 83, 45), (40, 33, 17)
    ragged = build_patch_grid(ragged_vol, ragged_patch, (23, 19, 11))
    err_r, _, _, _ = _kernel_vs_plain(ragged_vol + (3,), ragged_patch,
                                      ragged[-7:], gen, "ragged geometry")
    return dict(max_abs_err=max(err, err_r), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def phase_forward_card_vs_cpu():
    from vnet_tpu_torch.models import build_network, eval_apply

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    net = build_network("VNet", num_classes=3, norm="batch", device="cpu",
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
        norm=net_cfg["Norm"], device="cpu",
        generator=torch.Generator().manual_seed(SEED))
    checkpoints.save(ts["CheckpointDir"], net.state_dict(), 0)
    n_batches_per_case = -(-12 // SLICE_BATCH)

    reset_counts()
    t0 = time.perf_counter()
    results = main(["-p", "evaluate", "--config_json", cfg_path,
                    "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["blend_accumulate"]

    say(f"[4] main path: {len(results)} cases in {wall:.2f} s "
        f"({wall / 2:.2f} s per case incl. model build, checkpoint load and "
        f"first-call warm-up); blend launches {launches}, batches "
        f"{2 * n_batches_per_case}")
    check(len(results) == 2, f"{len(results)} labels written, expected 2")
    check(launches == 2 * n_batches_per_case,
          "blend kernel launches != patch batches")
    check(launches == sum(counts.values()),
          f"evaluation launched other kernels: {counts}")
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


def _counted():
    from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                          blend_accumulate_rows)
    from vnet_tpu_torch.ops.dropout import dropout_apply
    from vnet_tpu_torch.ops.dw_conv import dw_conv
    from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_stats,
                                          fused_bias_prelu_residual)

    return {"blend_accumulate": blend_accumulate_patches,
            "dropout": dropout_apply, "dw_conv": dw_conv,
            "bn_stats": bn_stats, "bn_grad_stats": bn_grad_stats,
            "bias_prelu_residual": fused_bias_prelu_residual,
            "blend_rows": blend_accumulate_rows}


def reset_counts() -> None:
    for wrapper in _counted().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in _counted().items()}


def phase_dropout():
    """Dropout kernel vs plain at the main path's largest dropout."""
    import torch.nn.functional as F

    from vnet_tpu_torch.ops.dropout import (dropout, dropout_apply,
                                            dropout_params, dropout_plain)

    rate, seed, stream = 0.01, 20261016, 3
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((FLAGSHIP_BATCH, 16) + TRAIN_PATCH, generator=gen,
                    device="cuda").to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last_3d)
    nonzero = x != 0
    n = int(nonzero.sum())
    bound_ms = 2 * x.nbytes / HBM_BYTES_PER_S * 1e3  # read x, write out
    result = {}
    for impl in ("pallas", "bits8"):
        thr, scale = dropout_params(rate, impl)
        out_k = dropout_apply(x, seed, stream, thr, scale)
        out_p = dropout_plain(x, seed, stream, thr, scale)
        torch.cuda.synchronize()
        equal = torch.equal(out_k, out_p)
        err = (out_k.float() - out_p.float()).abs().max().item()
        p = thr / 2.0 ** 32
        kept = int(((out_k != 0) & nonzero).sum())
        sigmas = abs(kept - n * p) / (n * p * (1 - p)) ** 0.5
        del out_p
        xr = x.detach().requires_grad_()
        y = dropout(xr, seed, stream, rate, impl)
        g = torch.ones(y.shape, dtype=y.dtype, device="cuda")  # not CL
        (dx,) = torch.autograd.grad(y, xr, g)
        same_mask = bool((((dx != 0) == (y != 0)) | ~nonzero).all())
        del xr, y, g, dx
        ms = time_ms(lambda: dropout_apply(x, seed, stream, thr, scale))
        plain_ms = time_ms(lambda: dropout_plain(x, seed, stream, thr,
                                                 scale), reps=3)
        lib_ms = time_ms(lambda: F.dropout(x, rate, training=True))
        say(f"[5] dropout {impl} {tuple(x.shape)} bf16 channels-last: "
            f"bitwise_equal={equal} keep {kept / n:.6f} (p {p:.6f}, "
            f"{sigmas:.2f} sigma) backward_mask_equal={same_mask}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms F.dropout {lib_ms:.4f} ms "
            f"byte bound {bound_ms:.4f} ms")
        check(equal, f"dropout {impl}: kernel differs from the plain version")
        check(sigmas < 5.0, f"dropout {impl}: keep fraction off by "
                            f"{sigmas:.1f} sigma")
        check(same_mask, f"dropout {impl}: backward mask != forward mask")
        result[impl] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by="bytes",
                            library_ms=lib_ms)
    return result["pallas"]


DW_SHAPES = (  # (Ci, Co, side, k) at batch 96: the main path's stride-1 convs
    (16, 16, 64, 5), (32, 16, 64, 5), (128, 128, 8, 5), (256, 256, 4, 5),
    (16, 3, 64, 1))


def phase_dw():
    """dW kernel vs plain at the main path's shapes; the kernels line
    reports the sums over the five shapes."""
    from vnet_tpu_torch.ops.dw_conv import dw_conv, dw_conv_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cl = torch.channels_last_3d
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, flops=0.0, bytes=0.0)
    for ci, co, side, k in DW_SHAPES:
        vol = (side,) * 3
        x = torch.randn((FLAGSHIP_BATCH, ci) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        g = torch.randn((FLAGSHIP_BATCH, co) + vol, generator=gen,
                        device="cuda").to(torch.bfloat16).contiguous(
                            memory_format=cl)
        ks = (k,) * 3
        out_k = dw_conv(x, g, ks)
        out_p = dw_conv_plain(x, g, ks)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        scale = out_p.abs().max().item()
        del out_k, out_p
        w = torch.empty((co, ci) + ks, dtype=torch.bfloat16, device="cuda")
        pad = ((k - 1) // 2,) * 3
        ms = time_ms(lambda: dw_conv(x, g, ks), reps=5)
        plain_ms = time_ms(lambda: dw_conv_plain(x, g, ks), reps=1,
                           warmup=False)
        lib_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, (1, 1, 1), pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False)), reps=5)
        flops = 2.0 * (x.numel() // ci) * k ** 3 * ci * co
        nbytes = x.nbytes + g.nbytes + co * ci * k ** 3 * 4
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        say(f"[6] dW {ci}->{co} k{k} at {side}^3 batch {FLAGSHIP_BATCH} "
            f"bf16: max|diff| {err:.3e} max|dW| {scale:.3e} (tolerance "
            f"{DW_RTOL:g} x max|dW|); kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms "
            f"cuDNN {lib_ms:.3f} ms bound {bound_ms:.4f} ms "
            f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB)")
        check(err <= DW_RTOL * scale,
              f"dW {ci}->{co} k{k}: kernel differs from the plain version")
        total["max_abs_err"] = max(total["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound_ms),
                       ("flops", flops), ("bytes", nbytes)):
            total[key] += v
        del x, g, w
    bound_by = ("operations" if total["flops"] / BF16_FLOPS
                > total["bytes"] / HBM_BYTES_PER_S else "bytes")
    say(f"[6] dW over the five shapes: kernel {total['ms']:.3f} ms, cuDNN "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms "
        f"({bound_by})")
    del total["flops"], total["bytes"]
    return dict(total, bound_by=bound_by)


def _train_case(rng):
    """A 96x96x80 volume at 0.75 mm: noise around 100 (sigma 20), a bright
    sphere labelled 1 (radius 14) holding a brighter core labelled 2
    (radius 6)."""
    img = rng.normal(100.0, 20.0, size=TRAIN_CASE).astype(np.float32)
    label = np.zeros(TRAIN_CASE, np.uint8)
    x, y, z = np.ogrid[tuple(slice(0, s) for s in TRAIN_CASE)]
    cx, cy, cz = (int(rng.integers(20, s - 20)) for s in TRAIN_CASE)
    d2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
    img[d2 <= 196] += 40.0
    label[d2 <= 196] = 1
    img[d2 <= 36] += 40.0
    label[d2 <= 36] = 2
    return img, label


def _write_train_config(tmp):
    import yaml

    with open(TRAIN_CONFIG) as f:
        cfg = json.load(f)
    ts = cfg["TrainingSetting"]
    ts["Data"]["TrainingDataDirectory"] = os.path.join(tmp, "training")
    ts["Data"]["TestingDataDirectory"] = os.path.join(tmp, "training")
    ts.update(PatchShape=list(TRAIN_PATCH), BatchSize=4, MaxIterations=4,
              LogInterval=2, Testing=False, Restore=False,
              LogDir=os.path.join(tmp, "log"),
              CheckpointDir=os.path.join(tmp, "ckpt"),
              Pipeline=os.path.join(tmp, "pipeline.yaml"))
    ts["Networks"].update(DropoutImpl="pallas", DwImpl="pallas")
    crop = {"output_size": list(TRAIN_PATCH)}
    pipeline = {"preprocess": {"train": {"3D": [
        {"name": "StatisticalNormalization", "variables": {"sigma": 2.5}},
        {"name": "Resample", "variables": {"voxel_size": [0.75] * 3}},
        {"name": "Padding", "variables": crop},
        {"name": "ConfidenceCrop2",
         "variables": dict(crop, rand_range=16, probability=0.8)},
        {"name": "RandomNoise"}]}}}
    with open(ts["Pipeline"], "w") as f:
        yaml.safe_dump(pipeline, f)
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, cfg


def phase_train(tmp):
    """The training main path through the CLI's ``main``."""
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.io import MedicalImage, write_image
    from vnet_tpu_torch.train import Trainer, checkpoints

    cfg_path, cfg = _write_train_config(tmp)
    ts = cfg["TrainingSetting"]
    rng = np.random.default_rng(SEED)
    for i in range(8):
        img, label = _train_case(rng)
        case_dir = os.path.join(tmp, "training", f"case_{i}")
        os.makedirs(case_dir)
        write_image(MedicalImage(img, (0.75,) * 3),
                    os.path.join(case_dir, "image.nii"))
        write_image(MedicalImage(label, (0.75,) * 3),
                    os.path.join(case_dir, "label.nii"))

    reset_counts()
    t0 = time.perf_counter()
    state = main(["-p", "train", "--config_json", cfg_path,
                  "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    steps = ts["MaxIterations"]
    n_dropout = len(state.network.dropouts)
    n_dw = sum(1 for m in state.network.modules()
               if getattr(m, "dw_impl", None) == "pallas"
               and m.strides == (1, 1, 1))
    with open(os.path.join(ts["LogDir"], "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    say(f"[7] train main path: {steps} steps at batch {ts['BatchSize']}, "
        f"patch {TRAIN_PATCH}, in {wall:.2f} s (incl. data loading, model "
        f"build, first-call warm-up, checkpoints); losses {losses}; "
        f"launches {counts}; module tree: {n_dropout} dropout layers, "
        f"{n_dw} stride-1 convs")
    check(state.step == steps, f"trained {state.step} steps, not {steps}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    check(n_dropout == 21 and n_dw == 22,
          f"module tree: {n_dropout} dropouts, {n_dw} stride-1 convs")
    check(counts["dropout"] == 2 * n_dropout * steps,
          f"dropout launches {counts['dropout']} != {2 * n_dropout * steps}")
    check(counts["dw_conv"] == n_dw * steps,
          f"dW launches {counts['dw_conv']} != {n_dw * steps}")
    check(counts["dropout"] + counts["dw_conv"] == sum(counts.values()),
          f"training launched other kernels: {counts}")

    saved = checkpoints.restore_latest_state(ts["CheckpointDir"])
    check(saved is not None and saved["step"] == steps,
          "no checkpoint of the last step")
    fresh = Trainer(load_config(cfg_path), device="cuda", log=False)
    fresh.network.load_state_dict(saved["model"])
    fresh.optimizer.load_state_dict(saved["optimizer"])
    trained = state.network.state_dict()
    same = all(torch.equal(v, trained[k])
               for k, v in fresh.network.state_dict().items())
    say(f"[7] checkpoint step {saved['step']} epoch {saved['epoch']} "
        f"restores into a fresh trainer: weights equal={same}")
    check(same, "restored weights differ from the trained ones")
    return counts


def _flagship_steps(impl, batch):
    from vnet_tpu_torch.tools.profile_step import flagship_step, timed_steps

    state, step, images, labels = flagship_step(impl, batch, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    times, losses = timed_steps(state, step, images, labels, 4)
    # the first step is warm-up
    return (statistics.median(times[1:]), torch.cuda.max_memory_allocated(),
            losses)


def phase_flagship():
    """``bench.py``'s flagship step (batch 96, 64^3), kernels vs library."""
    result = {}
    for impl in ("pallas", "xla"):
        batch = FLAGSHIP_BATCH
        while True:
            try:
                ms, peak, losses = _flagship_steps(impl, batch)
                break
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                say(f"[8] {impl}: batch {batch} does not fit in memory")
                check(batch > 8, "not even batch 8 fits")
                batch //= 2
        torch.cuda.empty_cache()
        say(f"[8] flagship step, DropoutImpl/DwImpl {impl}: batch {batch} "
            f"64^3 bf16: median {ms:.1f} ms per step, "
            f"{batch / ms * 1e3:.1f} patches/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB; losses {losses}")
        check(all(np.isfinite(losses)), f"flagship losses {losses}")
        result[impl] = (batch, ms)
    return result


BN_SHAPES = (  # (shape, groups): the flagship step's BN inputs at batch 96
    ((96, 64, 64, 64, 16), 1), ((96, 32, 32, 32, 32), 1),
    ((96, 8, 8, 8, 128), 1), ((96, 64, 64, 64, 3), 1),
    ((96, 32, 32, 32, 128), 8))


def _sums_close(got, ref, terms, label):
    """Per channel ``|got - ref| <= BN_RTOL * sum|terms|``; returns the max
    |diff| and the largest ratio of |diff| to its bound."""
    bound = BN_RTOL * terms.abs().reshape(-1, terms.shape[-1]).sum(0)
    diff = (got - ref).abs()
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    check(bool((diff <= bound).all()), f"{label}: |kernel - plain| "
                                       f"exceeds {BN_RTOL:g} x sum|terms|")
    return diff.max().item(), ratio


def _bn_stats_shape(shape, gen):
    from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_grad_stats_plain,
                                          bn_stats, bn_stats_plain)

    # nonzero means, as a BN input after a PReLU has, and dy correlated with
    # x: no sum is near zero, so the bound is relative to each sum
    x = (torch.randn(shape, generator=gen, device="cuda") + 1.0).to(
        torch.bfloat16)
    dy = (torch.randn(shape, generator=gen, device="cuda")
          + 0.5 * x.float()).to(torch.bfloat16)
    c = shape[-1]
    rows = x.numel() // c
    label = f"{tuple(shape)} bf16"
    s_k, s_k2, s_p = bn_stats(x), bn_stats(x), bn_stats_plain(x)
    mean = s_p[0] / rows
    inv = torch.rsqrt(s_p[1] / rows - mean.square() + 1e-3)
    g_k = bn_grad_stats(dy, x, mean, inv)
    g_k2 = bn_grad_stats(dy, x, mean, inv)
    g_p = bn_grad_stats_plain(dy, x, mean, inv)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(s_k + g_k, s_k2 + g_k2))
    check(same, f"{label}: two kernel runs differ")
    xf = x.float()
    err_s = max(_sums_close(s_k[0], s_p[0], xf, f"bn_stats sum {label}"),
                _sums_close(s_k[1], s_p[1], xf * xf,
                            f"bn_stats sumsq {label}"))
    del xf
    dyf = dy.float()
    xhat = (x.float() - mean) * inv
    err_g = max(_sums_close(g_k[0], g_p[0], dyf,
                            f"bn_grad_stats sum_dy {label}"),
                _sums_close(g_k[1], g_p[1], dyf * xhat,
                            f"bn_grad_stats sum_dy_xhat {label}"))
    del dyf, xhat
    # the library's single calls on the (B, C, ...) view
    xv, dyv = x.movedim(-1, 1), dy.movedim(-1, 1)
    ms_s = time_ms(lambda: bn_stats(x))
    plain_s = time_ms(lambda: bn_stats_plain(x), reps=5)
    lib_s = time_ms(lambda: torch.batch_norm_stats(xv, 1e-3), reps=5)
    ms_g = time_ms(lambda: bn_grad_stats(dy, x, mean, inv))
    plain_g = time_ms(lambda: bn_grad_stats_plain(dy, x, mean, inv), reps=5)
    lib_g = time_ms(lambda: torch.batch_norm_backward_reduce(
        dyv, xv, mean, inv, None, True, False, False), reps=5)
    bound_s = (x.nbytes + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    bound_g = (2 * x.nbytes + 4 * c * 4) / HBM_BYTES_PER_S * 1e3
    say(f"[9] bn_stats {label}: bitwise reproducible={same}; max|diff| "
        f"{err_s[0]:.3e} ({err_s[1]:.3f} of the bound {BN_RTOL:g} x "
        f"sum|x|, sum x^2); kernel {ms_s:.4f} ms plain {plain_s:.4f} ms "
        f"torch.batch_norm_stats {lib_s:.4f} ms byte bound {bound_s:.4f} ms")
    say(f"[9] bn_grad_stats {label}: max|diff| {err_g[0]:.3e} "
        f"({err_g[1]:.3f} of the bound); kernel {ms_g:.4f} ms plain "
        f"{plain_g:.4f} ms torch.batch_norm_backward_reduce {lib_g:.4f} ms "
        f"byte bound {bound_g:.4f} ms")
    return ((err_s[0], ms_s, plain_s, bound_s, lib_s),
            (err_g[0], ms_g, plain_g, bound_g, lib_g))


def _bn_train(x, scale, bias, groups, grads_out):
    """``batch_norm_train`` forward and backward; ``grads_out`` are the
    gradients of (y, mean, var), None for an unused output."""
    from vnet_tpu_torch.ops.batchnorm import batch_norm_train

    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    outs = batch_norm_train(*leaves, 0.0, groups)
    used = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    grads = torch.autograd.grad([o for o, _ in used], leaves,
                                [g for _, g in used])
    return [o.detach() for o in outs], list(grads)


def _bn_train_agree(got, ref, x, scale, bias, groups, label):
    """mean and var within BN_RTOL of E|x| and E[x^2], y within one bf16
    ulp of its terms (2^-7 (|x a| + |b|)), gradients within BN_GRAD_RTOL of
    their max (dx, which is bf16, beyond one bf16 ulp of each element)."""
    (y, mean, var), grads = got
    (y_r, mean_r, var_r), grads_r = ref
    c = scale.shape[0]
    xg = x.float().reshape(-1, groups, c)
    e_abs, e_sq = xg.abs().mean((0, 1)), xg.square().mean((0, 1))
    check(bool(((mean - mean_r).abs() <= BN_RTOL * e_abs).all()),
          f"{label}: mean differs")
    check(bool(((var - var_r).abs() <= BN_RTOL * e_sq).all()),
          f"{label}: var differs")
    a = torch.rsqrt(var_r + 1e-3) * scale
    b = (bias - mean_r * a).repeat(groups)
    terms = (x.float() * a.repeat(groups)).abs() + b.abs()
    y_err = ((y.float() - y_r.float()).abs() / terms.clamp_min(1e-30)).max()
    check(y_err.item() <= BF16_ULP, f"{label}: y differs by more than one "
                                    f"bf16 ulp of its terms")
    g_err = []
    for name, g, g_r in zip(("dx", "dscale", "dbias"), grads, grads_r):
        g, g_r = g.float(), g_r.float()
        scale_g = g_r.abs().max().item()
        # a bf16 dx is the float32 dx rounded once: either neighbour is right
        ulp = BF16_ULP * g_r.abs() if name == "dx" else 0.0
        excess = ((g - g_r).abs() - ulp).clamp_min(0.0).max().item()
        g_err.append(excess / scale_g)
        check(excess <= BN_GRAD_RTOL * scale_g, f"{label}: {name} differs")
    say(f"[9] batch_norm_train {label}: mean/var within {BN_RTOL:g} of "
        f"E|x|/E[x^2]; y within {y_err.item():.3f} x 2^-7 (|x a| + |b|); "
        f"max|diff|/max|grad| dx {g_err[0]:.2e} (beyond one bf16 ulp) "
        f"dscale {g_err[1]:.2e} dbias {g_err[2]:.2e} (tolerance "
        f"{BN_GRAD_RTOL:g})")


def phase_bn():
    """BN statistics kernels vs plain at the flagship step's BN inputs,
    then ``batch_norm_train`` on the kernels vs ``xla`` and vs autograd of
    ``models.layers.BatchNorm``. Returns the kernels line's entries (sums
    over the five shapes) and the launches of the ``batch_norm_train``
    runs."""
    from vnet_tpu_torch.models.layers import BatchNorm
    from vnet_tpu_torch.ops import batchnorm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = [dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0) for _ in range(2)]
    for shape, _ in BN_SHAPES:
        for total, (err, *times) in zip(totals, _bn_stats_shape(shape, gen)):
            total["max_abs_err"] = max(total["max_abs_err"], err)
            for key, v in zip(("ms", "plain_ms", "bound_ms", "library_ms"),
                              times):
                total[key] += v
        torch.cuda.empty_cache()

    reset_counts()
    for shape, groups in (BN_SHAPES[0], BN_SHAPES[-1]):
        c = shape[-1] // groups
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda")
        dmean = torch.randn(c, generator=gen, device="cuda")
        dvar = torch.randn(c, generator=gen, device="cuda")
        label = f"{shape} groups {groups}"
        run = {}
        for impl in ("pallas", "xla"):
            batchnorm.STATS_IMPL = impl
            run[impl] = _bn_train(x, scale, bias, groups, (dy, dmean, dvar))
        _bn_train_agree(run["pallas"], run["xla"], x, scale, bias, groups,
                        f"{label} pallas vs xla")
        if groups == 1:
            batchnorm.STATS_IMPL = "pallas"
            got = _bn_train(x, scale, bias, 1, (dy, None, None))
            layer = BatchNorm(c).to("cuda").train()
            with torch.no_grad():
                layer.weight.copy_(scale)
                layer.bias.copy_(bias)
            xl = x.detach().requires_grad_()
            y_r = layer(xl.movedim(-1, 1), False).movedim(1, -1)
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            mean_r = xf.mean(axes)
            var_r = xf.square().mean(axes) - mean_r.square()
            del xf
            grads_r = torch.autograd.grad(y_r, (xl, layer.weight, layer.bias),
                                          dy)
            _bn_train_agree(got, ((y_r.detach(), mean_r, var_r),
                                  list(grads_r)), x, scale, bias, 1,
                            f"{label} pallas vs layers.BatchNorm autograd")
            del got, layer, xl, y_r, grads_r
        del run, x, dy
        torch.cuda.empty_cache()
    batchnorm.STATS_IMPL = "xla"
    counts = read_counts()
    say(f"[9] batch_norm_train launches (two shapes, pallas forward and "
        f"backward, plus the layers.BatchNorm comparison's): {counts}")
    check(counts["bn_stats"] == 3 and counts["bn_grad_stats"] == 3,
          f"batch_norm_train pallas launched {counts}")
    return ([dict(t, bound_by="bytes") for t in totals],
            (counts["bn_stats"], counts["bn_grad_stats"]))


def phase_tail():
    """Fused bias + PReLU + residual tail vs its plain version."""
    from vnet_tpu_torch.ops.fused import (fused_bias_prelu_residual,
                                          fused_bias_prelu_residual_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ragged = (7, 45, 37, 3)
    cases = []
    for shape, dtype in (((FLAGSHIP_BATCH,) + TRAIN_PATCH + (16,),
                          torch.bfloat16), (ragged, torch.float32)):
        n = int(np.prod(shape))
        c = shape[-1]
        if dtype == torch.float32:  # one element off 16-byte alignment
            x = torch.randn(n + 1, generator=gen, device="cuda")[1:].view(
                shape)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        res = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        bias = torch.randn(c, generator=gen, device="cuda").to(dtype)
        alpha = (0.1 + 0.2 * torch.rand(c, generator=gen, device="cuda")).to(
            dtype)
        cases.append((shape, dtype, (x, res, bias, alpha)))
    reset_counts()
    checked = []
    for shape, dtype, args in cases:
        out_k = fused_bias_prelu_residual(*args)
        out_p = fused_bias_prelu_residual_plain(*args)
        torch.cuda.synchronize()
        checked.append((torch.equal(out_k, out_p),
                        (out_k.float() - out_p.float()).abs().max().item()))
        del out_k, out_p
    launches = read_counts()["bias_prelu_residual"]
    check(launches == len(cases), f"fused tail launched {launches} times in "
                                  f"{len(cases)} checked calls")
    result = None
    for (shape, dtype, args), (equal, err) in zip(cases, checked):
        ms = time_ms(lambda: fused_bias_prelu_residual(*args))
        plain_ms = time_ms(lambda: fused_bias_prelu_residual_plain(*args),
                           reps=5)
        bound_ms = 3 * args[0].nbytes / HBM_BYTES_PER_S * 1e3  # x, res, out
        say(f"[10] fused_bias_prelu_residual {shape} {dtype}: "
            f"bitwise_equal={equal} max_abs_err={err:.3e}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms byte bound "
            f"{bound_ms:.4f} ms (no single PyTorch call)")
        check(equal, f"fused tail {shape}: kernel differs from the plain "
                     f"version")
        if result is None:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=None)
    say(f"[10] fused tail launches in the {len(cases)} checked calls: "
        f"{launches}")
    return result, launches


def _slice_row_starts():
    """Start rows of the z-lines of the evaluation slice's first patch
    batch in the flattened (X * Y * Z, C) accumulator, in patch order."""
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid

    grid = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, SLICE_STRIDE)
    i, j = np.meshgrid(np.arange(SLICE_PATCH[0]), np.arange(SLICE_PATCH[1]),
                       indexing="ij")
    vy, vz = SLICE_VOLUME[1:]
    return np.concatenate([(((sx + i) * vy + (sy + j)) * vz + sz).ravel()
                           for sx, sy, sz in grid[:SLICE_BATCH]]
                          ).astype(np.int32)


def _device_ms(fn, kernel: str, calls: int = 3):
    """Device time of the launches of ``kernel`` (a name fragment) per call
    of ``fn``, and their number per call, from a ``torch.profiler`` trace of
    ``calls`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return sum(spans) / 1e3 / calls, len(spans) / calls


def _rows_case(big_r, c, starts, window, gen, label):
    from vnet_tpu_torch.ops.blend import (blend_accumulate_rows,
                                          blend_accumulate_rows_plain,
                                          plan_rows)

    r = window.shape[0]
    st = torch.from_numpy(starts)
    acc0 = torch.rand((big_r, c), generator=gen, device="cuda")
    w0 = torch.rand((big_r, 1), generator=gen, device="cuda")
    probs = torch.rand((len(starts), r, c), generator=gen, device="cuda")
    acc_k, w_k = acc0.clone(), w0.clone()
    torch.cuda.synchronize()
    reset_counts()
    blend_accumulate_rows(acc_k, w_k, probs, window, st)
    launches = read_counts()["blend_rows"]
    acc_p, w_p = acc0.clone(), w0.clone()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    blend_accumulate_rows_plain(acc_p, w_p, probs, window, st)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    equal = torch.equal(acc_k, acc_p) and torch.equal(w_k, w_p)
    err = max((acc_k - acc_p).abs().max().item(),
              (w_k - w_p).abs().max().item())
    _, bounds = plan_rows(starts, r)
    check(launches == len(bounds) - 1, f"row blend {label}: {launches} "
                                       f"launches for {len(bounds) - 1} levels")

    def call():
        blend_accumulate_rows(acc_k, w_k, probs, window, st)

    t0 = time.perf_counter()
    plan_rows(starts, r)
    host_ms = (time.perf_counter() - t0) * 1e3
    ms, traced = _device_ms(call, "blend_rows_kernel")
    check(traced == launches, f"row blend {label}: the trace shows {traced} "
                              f"kernels per call, the count {launches}")
    call_ms = time_ms(call, reps=3, warmup=False)
    s = np.sort(starts.astype(np.int64))
    covered = int(np.minimum(np.diff(s), r).sum()) + r  # rows in the union
    nbytes = (2 * covered * (c + 1) * 4 + probs.nbytes + window.nbytes
              + starts.nbytes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[11] blend_accumulate_rows {label}: acc {tuple(acc0.shape)}, "
        f"{len(starts)} segments of {r} rows, {launches} launches (overlap "
        f"levels); bitwise_equal={equal} max_abs_err={err:.3e}; kernel "
        f"{ms:.4f} ms (device time of its launches, profiler) host "
        f"levelling {host_ms:.2f} ms whole call {call_ms:.2f} ms plain loop "
        f"{plain_ms:.1f} ms byte bound {bound_ms:.4f} ms "
        f"({nbytes / 1e9:.3f} GB; no single PyTorch call)")
    check(equal, f"row blend {label}: kernel differs from the plain loop")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None), launches


def phase_rows():
    """Row blend vs its plain loop at the evaluation slice's geometry and
    at a ragged one."""
    from vnet_tpu_torch.infer.sliding_window import cosine_window

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = SLICE_PATCH[2]
    window = torch.from_numpy(cosine_window((r,)).reshape(r, 1)).cuda()
    result, launches = _rows_case(int(np.prod(SLICE_VOLUME)), 3,
                                  _slice_row_starts(), window, gen,
                                  "slice geometry")
    rng = np.random.default_rng(SEED)
    big_r, r_small = 10007, 13
    starts = rng.integers(0, big_r - r_small + 1, size=3000)
    starts[1::7] = starts[::7][:len(starts[1::7])]  # duplicated starts
    _rows_case(big_r, 3, starts.astype(np.int32),
               torch.rand((r_small, 1), generator=gen, device="cuda") + 0.5,
               gen, "ragged geometry")
    return result, launches


def run():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke "
                 "run needs a CUDA card")
    import vnet_tpu_torch  # noqa: F401  (fails outside a checkout)

    card, smi = phase_device_and_build()
    blend = phase_kernel_vs_plain(card)
    phase_forward_card_vs_cpu()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_")
    try:
        launches, _, _ = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drop = phase_dropout()
    dw = phase_dw()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_train_")
    try:
        train_counts = phase_train(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_flagship()
    (stats, grad_stats), (n_stats, n_grad) = phase_bn()
    tail, n_tail = phase_tail()
    rows, n_rows = phase_rows()
    own = "its own phase ({}); no entry point reaches it"
    say(json.dumps({"kernels": [
        dict(name="blend_accumulate_patches", route="cuda",
             source="vnet_tpu_torch/csrc/blend_accumulate.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:220",
             launches=launches, launches_in="phase 4 (evaluation)", **blend),
        dict(name="pallas_dropout", route="cuda",
             source="vnet_tpu_torch/csrc/dropout.cu",
             replaces="vnet_tpu/ops/pallas/dropout.py:99",
             launches=train_counts["dropout"],
             launches_in="phase 7 (training)", **drop),
        dict(name="dw_conv_pallas", route="cuda",
             source="vnet_tpu_torch/csrc/dw_conv.cu",
             replaces="vnet_tpu/ops/pallas/dw_conv.py:209",
             launches=train_counts["dw_conv"],
             launches_in="phase 7 (training)", **dw),
        dict(name="bn_stats", route="cuda",
             source="vnet_tpu_torch/csrc/bn_stats.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:96", launches=n_stats,
             launches_in=own.format("phase 9, batch_norm_train"), **stats),
        dict(name="bn_grad_stats", route="cuda",
             source="vnet_tpu_torch/csrc/bn_stats.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:152", launches=n_grad,
             launches_in=own.format("phase 9, batch_norm_train"),
             **grad_stats),
        dict(name="fused_bias_prelu_residual", route="cuda",
             source="vnet_tpu_torch/csrc/bias_prelu_residual.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:50", launches=n_tail,
             launches_in=own.format("phase 10"), **tail),
        dict(name="blend_accumulate_rows", route="cuda",
             source="vnet_tpu_torch/csrc/blend_rows.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:332", launches=n_rows,
             launches_in=own.format("phase 11, slice geometry"), **rows)]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    run()
