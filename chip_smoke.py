"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure raises and exits
non-zero before the result line. Wherever a phase counts the kernels'
launches, every batch norm's launches (``bn_stats`` for its forward's
sums, then ``ops/bn_act.py``'s apply, gradient sums and dx) must equal what
its calls owe (``held_bn``: the sums and the apply once a call, the sums
only with batch statistics; the gradient sums and dx once each time
autograd differentiates a call's output, dx only where the input needs a
gradient); the other counts are then held as each phase says:

1. device and build: card name, ``nvidia-smi`` name and power limit,
   whether PyYAML and tensorboardX import; the seven kernel sources (blend,
   dropout, dW, BN statistics, fused tail, row blend, batch norm +
   activation) built from source in parallel, one ``nvcc`` each, with
   their build times and ptxas registers and spills; the tensor-core
   instructions in the SASS of the dW library's bf16 kernels
   (``cuobjdump --dump-sass``); the dropout kernels' SASS: no
   local memory, Philox's wide multiplies, its key schedule made once per
   loop (not per call), 16-byte loads and stores;
2. blend kernel vs its plain PyTorch version on the card, at the slice's
   shapes (10 contributions of (256, 256, 32, 4) f32 into a (384, 384, 64, 4)
   accumulator, starts overlapping on every axis), at the dense-stride
   (LiTS) geometry (the first 10 patches of the stride-16 grid of the same
   shapes), at a ragged geometry (odd extents, clamped starts, C = 3) and
   at the 2D evaluation's stacked geometry (10 contributions of (1, 256,
   256, 3) into (64, 384, 384, 3) at the first 10 ``(z, i, j)`` rows):
   results must be bitwise equal (same adds in the same order), the first
   two on the kernel's float4 path, the ragged one on its float path and
   the stacked one on the path its geometry implies;
   the kernel's device time from a ``torch.profiler`` trace, the wrapper
   call and the plain version with CUDA events (median of 25), beside the
   byte bound of the covered elements;
3. the full-width VNet forward (packed, as ``build_network`` builds it) of
   one (1, 256, 256, 32, 1) patch in f32 with TF32 off, on the card vs the
   same module on the CPU;
4. the main path: two synthetic 384x384x64 cases evaluated through
   ``python -m vnet_tpu_torch``'s ``main`` on ``cuda`` at the slice config
   (``configs/config_eval_gaussian.json``: the packed network, 16
   channels, 4 levels, bf16,
   patch 256x256x32, stride 128x128x16, batch 10, cosine blend, LCC, volume
   threshold 50) with random weights from a seeded generator; the blend
   kernel's launches must equal the number of patch batches and take its
   float4 path, outputs must exist, labels lie in {0, 1, 2}, probability
   maps are finite and agree with the plain slice-add blend (``BlendImpl:
   xla``) on the card;
5. dropout kernel vs its plain version at (96, 128, 32, 32, 32) bf16
   channels-last, the packed main path's largest dropout (64^3 x 16
   channels packed (2, 2, 2)), for ``pallas`` and
   ``bits8`` at the config's rate 0.01: bitwise equal, keep fraction within
   5 sigma, backward mask = forward mask for a gradient that is not
   channels-last. Then bitwise equal at every distinct dropout shape of the
   packed flagship step (``pallas`` and ``xla``, the module tree's five
   shapes from ``tools/dropout_bench.py``, 128 and 256 channels) and at the
   attention step's six, its heads' (8, 64, 64, 64, 64) among them
   (``xla``), ``xla`` survivors equal to
   ``x / keep_d`` rounded once
   (``keep_d``: 0.99 rounded to the dtype), and at a ragged, unaligned
   float32 and bf16 length (the scalar path); the division sweep: all 2^32
   float32 bit patterns through the ``xla`` kernel in 2^30-element launches
   at threshold 2^32 - 1 and the keep of rates 0.01, 0.1, 0.3, 0.5 and 0.9,
   bit for bit the plain division (NaNs as NaN) but where an element's word
   drops it (phase 17 times every shape);
6. dW kernel vs its plain version at the nine distinct weight gradients of
   the packed flagship step (``tools/dw_bench.py``'s ``dw_shapes``, from the
   module tree), batch 96 bf16: 128->128 and the 256->128 skip splice at
   3^3 on (32, 32, 32), at (3, 3, 5) on (16, 16, 32) and at (3, 5, 5) on
   (8, 16, 16), 128->128 and 256->128 at 5^3 on 8^3 (direct), 256->256 at
   5^3 on 4^3, each with its launches per step (21 in all): max |diff| <=
   DW_RTOL * max |dW| and two kernel runs bitwise equal; kernel ms,
   TFLOP/s, bound, plain and cuDNN weight-gradient ms, the planned regime;
   step-weighted sums (launches x ms over the nine shapes). The direct
   network's ten shapes (22 launches, the 1^3 output conv among them) under
   the same checks, untimed. Then edge cases under the same checks: odd
   extents with Z % 16 != 0 in both tensor-core regimes, f16, float32 (the
   CUDA-core kernel), a g that is not channels-last, 1^3, 3^3 and 7^3
   kernels. Phase 1 has checked that the bf16 tensor-core kernels' SASS
   holds HMMA (mma.sync) or HGMMA (wgmma) instructions;
7. the training main path: ``python -m vnet_tpu_torch -p train --devices
   0``'s ``main`` on ``cuda`` (on one card a process group of one rank
   under ``nccl``, checked, and no collective called) at
   ``configs/config.json``'s network (16 channels,
   4 levels, PReLU, batch norm, dropout 0.01, weighted Sorensen, Adam,
   bf16) with patch 64^3, ``DropoutImpl``/``DwImpl`` ``pallas``, batch 4,
   4 steps, on 8 synthetic 96x96x80 cases; the trainer builds the packed
   VNet; finite losses, launch counts of the module tree (21 dropout layers
   forward and backward, 21 weight gradients on the dW kernel, per step), a
   checkpoint that restores;
8. the training step at ``bench.py``'s flagship workload (batch 96, 64^3,
   random data) through ``make_train_step``, the packed network (as the
   trainer and ``bench.py`` build it) beside the direct one in the same
   process: median step time over 3 steps after a warm-up, patches/s, peak
   memory and the kernel launches a step (packed: 42 dropout and 21 dW;
   direct: 42 and 22), with the kernels and with ``xla`` dropout and dW;
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
   segments of 32 rows, the cosine window's z-profile), at a ragged
   geometry (duplicated starts, a segment flush with R) and with segments
   of 300 rows and 10 channels: bitwise equal, one accumulate launch per
   call (the count and a ``torch.profiler`` trace agree); from the trace
   the device time of the accumulate kernel, of the tile plan's kernels and
   of the starts' copy, then the whole call (host clock) and the plain
   loop; no segments launch nothing.

12. (run right after phase 1) the ``cuda``-marked tests
   (``tests/test_torch_cuda_*.py``, JAX-free) in a subprocess, ``python -m
   pytest --noconftest -m cuda``: none may fail and more than none must
   pass;
13. the attention-gated training step at
   ``configs/config_attention_multimodal.json``'s width (16 channels, 4
   levels, attention heads of 64 channels, 2 modalities, 2 classes, batch
   8, 64^3, bf16, mixed Sorensen plus the l2 attention loss x100, Adam)
   through ``Trainer.train_step`` on random images, labels and distance
   maps from seed 0: median step time over 6 steps after 2 warm-ups,
   patches/s, peak memory, finite losses with ``attention_loss``, and the
   dropout launches per step that the module tree implies (21 backbone and
   12 head layers, forward and backward);
14. the attention CLI path: ``main(["-p", "train", ..., "--profile_dir",
   d])`` for 4 steps at batch 4 and 64^3 from that config with ``ImageLog``,
   ``DeviceAugment`` and ``Testing`` on, on synthetic two-modality cases,
   then ``-p evaluate``: the TensorBoard event files decode with the port's
   reader (CRCs hold), their scalar tags equal ``scalars.jsonl``'s, image
   records hold PNGs, ``network_config.json`` has the JAX trainer's keys,
   the trace file exists, and evaluation launched the blend kernel and wrote
   labels in {0, 1};
15. the 2D main path through the CLI: ``main(["-p", "train", ...])`` on
   ``cuda`` at ``configs/config_2d.json``'s network at full width (VNet, 16
   channels, 4 levels, convolutions (1, 2, 3, 3), bottom 3, PReLU, batch
   norm, dropout 0.01 ``xla``, Sørensen, Adam, bf16), patch 256^2, its batch
   of 32, 4 steps, the shipped ``pipeline/pipeline2D.yaml``, ``Testing`` on
   (384^2 test crops every 2 steps), on 6 synthetic 320x320x48 cases (a
   sphere labelled 1, ``CacheCases`` 6): finite losses, 42 dropout launches
   a step (21 layers, forward and backward), no dW launch, a checkpoint that
   restores; then ``-p evaluate`` of 2 synthetic 384x384x64 cases at the
   config's evaluation settings (stride 256^2, batch 10, probability maps,
   LCC, volume threshold 50), slice-stacked: 26 blend launches a case, each
   held bitwise against the plain slice-adds on the same batch and on the
   path its geometry implies; labels in {0, 1}, finite probability maps,
   outputs of the source volume's size; the wall time of each part;
16. the 2D step and the 2D kernel shapes: ``make_train_step`` at
   ``config_2d.json``'s width, batch 32, 256^2, bf16, random data from seed
   0: median step time over 6 steps after 2 warm-ups, patches/s, peak
   memory, dropout launches a step and whether every dropout input is
   channels-last; the dropout kernel vs its plain version at the 2D
   packed network's largest dropout, (32, 64, 128, 128) bf16 channels-last,
   ``xla``: bitwise equal, survivors ``x / keep_d``, backward mask = forward
   mask for a gradient that is not channels-last, a channels-last output;
   bitwise at the other four 2D shapes; the plain version's time;
18. (run right after phase 3) the packed network against the direct one
   on the card, float32 with TF32 off, 8 channels, 2 levels, 16^3 (and
   32^2), ``PackedTargetLanes`` 64 (factors (2, 2, 2), (2, 2, 1), (2, 1, 1)):
   logits, every parameter gradient and the running averages of a training
   step within ``PACKED_RTOL`` of the largest of their kind, with one and
   two input channels and in 2D;
19. (run before phase 17) one training step (``Trainer.train_step``) and one
   evaluation (``Evaluator.evaluate_case`` of a synthetic 96x96x80 case) on
   the card for each network name this port added: ``UNet``, ``Dense`` (at
   32^3) and ``VNetLegacy`` at ``configs/config.json``'s settings, bf16,
   batch 2: finite losses, labels in {0, 1, 2}, finite probability maps of
   the case's shape; ``VNetLegacy`` with the kernels (42 dropout and 21 dW
   launches a step), ``UNet`` (11 dropout layers) and ``Dense`` (4) with
   the ``xla`` flavour of the dropout kernel, twice a layer a step;
20. (run after phase 19) data parallelism, two ``gloo`` ranks sharing the
   card (``parallel.launch(..., backend="gloo", device="cuda:0")``, one
   spawned process each) against one process, (a) and (b) by
   ``tools/dp_bench.py``'s functions: (a) the full-width packed flagship
   network's training step in float32 with TF32 off, global batch 4 at
   64^3, ``pallas`` dropout 0.01 through the kernel and the dW kernel:
   loss and running averages within ``dp_bench.RTOL`` of the largest of
   their kind, the ranks' and the one process's gradients each within
   ``dp_bench.F64_RTOL`` of the largest of the same step in float64 on the
   host's CPU, the parameters after Adam within ``dp_bench.RTOL`` beyond
   Adam's first-step amplification of the gradients' difference (a
   gradient near 0 moves its parameter by up to lr whatever its sign;
   ``dp_bench.LR``'s comment), the two ranks' parameters and averages
   bitwise equal, every dropout
   layer's mask joined over the ranks bitwise the single process's, 42
   dropout and 21 dW launches a rank; (b) the bf16 flagship step at global
   batch 96, 48 rows a rank: median step ms, each rank's peak memory and
   kernel launches a step (a functional reading: both ranks share one
   card); (d) one case of ``configs/config_eval_gaussian.json`` through
   ``Evaluator`` with the patch grid sharded over the ranks against one
   process: probabilities within ``DP_PROB_ATOL``, labels equal wherever
   the top two probabilities differ by more than ``DP_LABEL_GAP``, the
   blend kernel launched on each rank and every launch bitwise the plain
   slice-adds. (c), ``--devices 0`` under ``nccl`` at world size 1, is
   phase 7;
21. (run after phase 20) the quickstart's main path:
   ``vnet_tpu_torch.quickstart.main`` on ``cuda`` at the full-width 3D
   network (16 channels, 4 levels, convolutions (1, 2, 3, 3), bottom 3,
   dropout 0.01 ``xla``, ``PackedTargetLanes`` 128, bf16, 64^3, batch 8,
   ``--augment`` on the device, RandomCrop drop 0.3 / min_pixel 32) for
   ``QS_STEPS`` steps on ``QS_TRAIN`` generated 96x96x64 cases, then the
   evaluation of its 4 held-out cases (stride 32^3, batch 4): the dropout
   kernel launched twice per dropout layer per step (the module tree's 21
   layers), the blend kernel once per patch batch of the evaluation, each
   dropout and blend launch held bitwise against its plain version on the
   same inputs (the blend on the float path its geometry implies), one
   per-class Dice per case, each finite and in [0, 1], the result line
   parsed, the device's idle share over a window of steps; then
   ``--rank2 --small`` for a few steps: both evaluation modes' prediction
   files written, blend launches once per slice-stacked batch, each held
   bitwise against the plain slice-adds;
22. (run after phase 21) the flag command lines:
   ``vnet_tpu_torch.flags.train --attention --dropout_impl bits8
   --device_augment`` for 2 steps at batch 2 and 32^3 on generated 48^3
   cases (the flag CLI's full-width network), then
   ``vnet_tpu_torch.flags.evaluate --attention`` on its checkpoint: the
   dropout kernel launched twice per layer per step (backbone and heads),
   each launch the bits8 flavour and bitwise its plain version on the same
   input, a label per case in {0, 1}, blend launches once per patch batch,
   each bitwise the plain slice-adds;
23. (run after phase 20) spatial partitioning, two ``gloo`` ranks sharing
   the card at ``SpaceParallel`` 2 (halos staged through host memory):
   (a) the float32 full-width packed flagship trainer step (16 channels,
   4 levels, (1, 2, 3, 3), bottom 3, dropout 0.01 ``pallas``) at 64^3,
   batch 2, each rank a 32x64x64 slab of every patch, against one process
   (``tools/sp_bench.py``: loss, gradients, running averages and the
   parameters after Adam held as phase 20 holds them, the one process's
   gradients within ``dp_bench.F64_RTOL`` of the float64 step on the
   host's CPU and the ranks' no farther from it than the one process's;
   every dropout mask joined over the
   slabs bitwise the one process's, every dropout launch of the ranks held
   bitwise against ``dropout_plain`` with its row map);
   (b) the bf16 step at batch ``SP_BATCH``: its first step with every
   dropout launch held as in (a) at the slab shapes and row maps the
   flagship's inputs give, then median ms and peak memory a rank, halo
   exchanges a step; the launches counted from before (a) to after (c);
   (c) ``spatial_sharded_forward`` of one
   384x384x64 volume at ``config_eval_gaussian.json``'s network, float32
   with TF32 off, against the unsharded forward;
24. (run after phase 22) export and the native runtime at
   ``config_eval_gaussian.json``'s full width (the packed network, 16
   channels, 4 levels, bf16, patch 256x256x32, batch 10, 3 classes, random
   weights from a seeded generator): the eval forward exported
   (``torch.export``) and compiled into AOTInductor packages for ``cuda``,
   in bf16 and, at a cut depth (2 levels), in float32, with the seconds
   of each step; each package
   loaded in Python and held on one batch of 10 windowed patches against
   the eager module's softmax on the card (float32 with TF32 off within
   ``EXPORT_F32_ATOL``; bf16: max |diff| and the share of equal argmax
   labels, at least ``EXPORT_BF16_AGREE``); ``vnet_infer_torch`` built
   from source with ``g++`` against libtorch CUDA (during the compiles)
   and run on one synthetic 384x384x64 volume with the bf16 package: it
   names a ``cuda`` device, its labels lie in {0, 1, 2} on the input's
   geometry, no port kernel launches, and its label agrees with the
   Python ``Evaluator``'s on the same volume and weights (cosine blend,
   LCC and volume threshold off, as the native client has none) on at
   least ``NATIVE_AGREE`` of the voxels; the runner's seconds a volume
   beside the ``Evaluator``'s steady seconds a case;
25. (run after phase 24) ``Remat``: (a) the flagship step (64^3, float32
   with TF32 off, cuDNN deterministic, ``pallas`` dropout and dW) at batch
   ``REMAT_CHECK_BATCH`` without and with ``Remat``: equal losses and
   running averages, gradients within ``REMAT_GRAD_RTOL`` of the largest,
   every dropout launch held bitwise against its plain version, each
   layer's forward mask the plain network's and each recomputed mask its
   forward's, 21 dW launches in both and 42 against 54 dropout launches;
   (b) the bf16 flagship step at batch ``REMAT_BATCH`` without and with
   ``Remat``: median ms, peak memory (lower with ``Remat``), launches a
   step; (c) the main path: ``python -m vnet_tpu_torch -p train`` on
   ``configs/config.json``'s ``TrainingSetting`` (batch 32 at [256, 256,
   32], its pipeline, ``xla`` dropout) with ``Remat: true`` for
   ``REMAT_STEPS`` steps on ``REMAT_CASES`` LiTS-shaped synthetic cases
   (320x320x48, ``utils/synthdata.py``): the network recomputes, the
   losses are finite, 54 dropout launches a step, each held bitwise
   against its plain version in the ``xla`` flavour (forward, recompute
   and backward at config.json's shapes), no dW launch, the wall and the
   peak memory;
26. (run after phase 25; (c) and the blend at (a)'s geometry run right
   after phase 11, with the process's other traces) the evaluation and
   diagnostic tools: (a) ``tools/benchmark_eval.py``'s engine (the packed
   full-width V-Net, bf16, random weights from seed 0) on a resident
   512^3 volume at stride 64 and batch 128 with the ``pallas`` and the
   ``xla`` blend through one network instance: each of the four kernel
   launches of a call held bitwise against the plain slice-adds on a
   clone of the 2 GiB accumulator, labels equal and accumulators within
   ``BENCH_RTOL``; the copy's seconds, and per blend the median of
   ``BENCH_REPS`` reps (argmax and a scalar fetch inside), the first call
   and the peak memory; before that, the kernel alone at that geometry
   (one launch of 128 64^3 patches) against its plain version, timed
   beside its byte bound, and at a ``BENCH_MARGIN``^3 accumulator with
   patches at the far corners, both float paths, bitwise; (b)
   ``experiments/eval2d.py``'s engines on a resident 16x512x512 stack,
   stacked and one call a slice, every stacked blend launch held bitwise:
   in float32 with TF32 off, probabilities within ``DP_PROB_ATOL`` and
   labels equal wherever the top two differ by more than
   ``DP_LABEL_GAP``; in the tool's bf16, probabilities within
   ``EVAL2D_BF16_ATOL`` and labels equal wherever the top two differ by
   more than twice the largest difference (the two modes put a patch at
   other rows of other batches, and the card's bf16 convolutions round a
   patch's logits by its row: the logits of the same patches at two rows
   are printed); (c) ``tools/analyze_trace.py`` over a
   ``profiler.TraceCapture`` trace of one warm 512^3 engine call: busy
   time above 0, the blend kernel among the top ops with its four
   launches, group totals at least the busy time; (d)
   ``tools/benchmark_loader.py`` (a process each, ``thread`` and
   ``process`` backends, the host's CPUs as workers) at 4 cases of
   96x96x48 for 4 batches: every variant's patches/s; (e) on phase 21's
   quickstart workdir, ``experiments/eval_only.py`` with both blends
   (every kernel launch held bitwise), ``experiments/compare_preds.py``
   on the two prediction sets (exit code 0) and
   ``experiments/patch_diagnose.py`` on one case;
27. (run after phase 26) the 2D quality probes and the training-step A/B
   trio: (a) the quickstart's ``--rank2`` mode at full width (16
   channels, 4 levels, bf16, batch 32, 96x96 slices, dropout 0.01
   ``xla``) for ``Q2D_STEPS`` steps on ``Q2D_TRAIN`` generated 96x96x64
   cases, then its evaluation of 4 cases in both modes, every dropout and
   blend launch held bitwise as in phase 21; (b) on that workdir the five
   ``experiments/diag2d`` tools with ``--device cuda`` (the oracle sweep at
   one contrast and one case): each exits 0 and prints its lines, and
   ``probe2d_r5b`` launches the dropout kernel once a dropout layer of the
   2D network, one train-mode forward, each launch held bitwise; (c)
   ``experiments/ab_train.py`` of ``AB_TAGS`` (64^3, batch 96) with
   ``--reps 1`` in this process (``--inproc``) under the launch counters:
   the dropout kernel 2 x 21 times a step, the dW kernel 21 times a step
   for ``pdw_b96_k16`` and never for ``base_b96_k4``; then the CLI of
   ``smoke_b2_k1`` (a child process) and ``experiments/capture_trace.py``
   of ``base_b96_k4`` in a process of its own, its trace read by
   ``tools/analyze_trace.py`` (busy time above 0, the dropout and dW
   kernels absent or present as the tag sets them); (d)
   ``tools/select_bench_tuning.py`` over (c)'s log, into the phase's
   directory: ``configs/bench_tuning.json`` byte for byte as before;
28. (run right after phase 26 (c)) the fused batch norm + activation
   kernels (``csrc/bn_act.cu``, ``ops/bn_act.py``): each pass against its
   plain version at every distinct batch-norm site of the benchmark's three
   cells in bf16 (``tools/bn_act_bench.py``: config.json's packed V-Net at
   batch 32 and [256, 256, 32], the attention-gated one at batch 16 and
   64^3, config_eval_gaussian's at batch 10 with running averages) and at
   the output norm's C = 3 unpacked (cell 1's is packed 24): the forward's
   sums (``bn_stats``) and the gradient sums per channel within
   ``bn_act_bench.STATS_RTOL`` of the sum of |terms|, the apply pass
   (output, saved statistics, running averages) bitwise given the same
   sums, dx within one bf16 ulp; the
   level-0 packed site (32, 128, 128, 128, 16) timed forward and backward
   beside its byte bound and the eager chain; a traced training step of
   the small flagship (with and without ``Remat``) and attention networks:
   the forward's sums and apply once per batch-norm call, gradient sums
   and dx once per site, the trace's kernels the counted ones and none
   named like a
   convolution, matrix product, optimizer or copy kernel; ``export_forward``
   of a small V-Net on ``cuda`` launches none of them and agrees with the
   module's eval forward, which does;
17. (run last) ``python -m vnet_tpu_torch.tools.dropout_bench`` in a
   process of its own: the dropout kernel at every dropout shape of the
   flagship (``pallas``, ``bits8``, ``xla``), attention and 2D (``xla``)
   steps, bf16 channels-last: device ms a launch (the median of a warm
   profiler trace), CUDA-event ms around 50 or more launches over inputs
   that fill twice the L2 cache, around one wrapper call (host time
   included, as earlier readings were taken), the wrapper's host us a call,
   ``F.dropout``'s device and event ms, the byte bound, and the sums per
   step. A process of its own, because after many traces in one process a
   later trace can hold no device events.

Phase 11 runs right after phase 2, so that every ``torch.profiler`` trace
of this process comes before its first CLI run (phase 4): on the H100
machine a trace taken after a CLI run now and then held no device events.
Phases 15 and 16 run before phase 14. No entry point reaches the kernels
of phases 9-11 (as in the JAX package);
their launches in the ``kernels`` line are the counts of their own phase.
The last lines are a JSON object describing each kernel, the card's name
and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
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
ATTENTION_CONFIG = os.path.join(ROOT, "configs",
                                "config_attention_multimodal.json")
KERNELS = ("blend_accumulate", "dropout", "dw_conv", "bn_stats",
           "bias_prelu_residual", "blend_rows", "bn_act")
SLICE_VOLUME = (384, 384, 64)
SLICE_PATCH = (256, 256, 32)
SLICE_STRIDE = (128, 128, 16)
SLICE_BATCH = 10
SEED = 0
# phase 3: f32 on the card (TF32 off) vs f32 on the CPU differ only by
# summation order; allowed max |diff| relative to the largest CPU logit
FORWARD_RTOL = 1e-3
# phase 18: the packed network vs the direct one on the card, f32 with TF32
# off: the same function by two computations, summed in other orders;
# allowed max |diff| relative to the largest entry of its kind (logits;
# gradients; running averages), as the CPU tests hold the port to JAX
PACKED_RTOL = 1e-4
# phase 6: sums of bf16 products (exact in float32) over up to 25M positions,
# in another order than the plain version's: tensor-core sums over at most
# 512 positions, float32 beyond; allowed max |diff| relative to max |dW|
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
# the packed flagship's largest dropout input (level 0: 64^3 x 16 channels
# packed (2, 2, 2)) and the 2D network's (256^2 x 16 packed (2, 2))
FLAGSHIP_DROP = (96, 128, 32, 32, 32)
DROP_2D = (32, 64, 128, 128)
TRAIN_CASE = (96, 96, 80)
FLAGSHIP_BATCH = 96
ATT_BATCH = 8  # config_attention_multimodal.json's BatchSize
ATT_CHANNELS = 64  # the attention heads' width
ATT_STEPS, ATT_WARMUP = 6, 2
CONFIG_2D = os.path.join(ROOT, "configs", "config_2d.json")
CASE_2D = (320, 320, 48)  # training cases of phase 15
PATCH_2D = (256, 256)
BATCH_2D = 32  # config_2d.json's BatchSize
EVAL_STRIDE_2D = (256, 256)  # config_2d.json's evaluation Stride
# phase 20: two gloo ranks on the one card against one process; (a) and
# (b) and their tolerances are tools/dp_bench.py's
DP_RANKS = 2
DP_TIMEOUT = 420.0
# phase 21: the quickstart at full width, cut to a few steps and cases
QS_STEPS = 20
QS_TRAIN = 16
QS_IDLE_WINDOW = (10, 8)  # steps 11-18: after the first-call warm-up
QS2D_STEPS = 4
# (d): the same batches through the same kernels, the accumulators summed
# across ranks in another order than one process adds them
DP_PROB_ATOL = 1e-5
DP_LABEL_GAP = 1e-4
# phase 24: the AOTInductor package against the eager module on the card.
# float32 with TF32 off: the same function, Inductor's fused kernels
# summing in other orders; allowed max |diff| of the probabilities
EXPORT_F32_ATOL = 1e-4
# bf16: Inductor rounds to bf16 at other places than the eager layers do
# (it keeps fused intermediates in float32), so labels can flip where the
# two highest probabilities nearly tie; the least share of equal labels
EXPORT_BF16_AGREE = 0.99
# vnet_infer_torch against the Python Evaluator on one volume: the same
# windowed, unresampled voxels (window in float32 against float64), the
# package's bf16 rounding against the eager module's, the same uniform
# blend; the least share of equal labels
NATIVE_AGREE = 0.99
# phase 25: Remat against the plain network. (a) runs the same kernels on
# the same inputs (TF32 off, cuDNN deterministic) with the recompute's
# activations equal to the forward's; its gradients go through the same
# sums, allowed max |diff| relative to the largest gradient (the CPU
# test's)
REMAT_GRAD_RTOL = 1e-5
REMAT_CHECK_BATCH = 4
REMAT_BATCH = 32  # (b), cut from 96
# (c): LiTS-shaped cases; the loader draws one patch a case an epoch, so
# config.json's batch needs as many cases
REMAT_CASES = 32
REMAT_STEPS = 3
LITS_CASE = (320, 320, 48)
# phase 23: two gloo ranks on the one card at SpaceParallel 2; (a)'s
# tolerances are tools/dp_bench.py's (phase 20's), (b)'s batch is cut from
# 96 so the halos staged through host memory keep the phase short
SP_RANKS = 2
SP_BATCH = 16
SP_TIMEOUT = 420.0
# (c): the same float32 convolutions on slabs with halos against the whole
# volume, cuDNN free to pick other algorithms for the other shapes; allowed
# max |diff| relative to the largest logit
SP_FORWARD_RTOL = 1e-4
# phase 26: the evaluation and diagnostic tools. (a) tools/benchmark_eval.py's
# defaults (512^3, patch, stride 64, batch 128: 512 patches in 4 launches of
# 128, a (512, 512, 512, 4) float32 accumulator of 2 GiB); the two blends
# add the same numbers in the same order through one network instance, so
# the accumulators must agree within BENCH_RTOL of the largest sum (they
# are equal unless cuDNN computes the same batch twice differently)
BENCH_SIZE, BENCH_PATCH, BENCH_STRIDE, BENCH_BATCH = 512, 64, 64, 128
BENCH_REPS = 3
BENCH_RTOL = 1e-5
# the blend kernel's offsets at a larger accumulator than (a)'s, as a margin
BENCH_MARGIN = 640
# (b) experiments/eval2d.py's 512x512 stack, cut from 64 slices to 16; the
# two modes put a patch at other rows of other batches, and the card's
# bf16 convolutions round a patch's logits by its row: in float32 with
# TF32 off the modes are held as phase 20's sharded evaluation is
# (DP_PROB_ATOL, DP_LABEL_GAP); in bf16 labels may flip only where the top
# two probabilities differ by less than twice the largest difference, which
# stays within EVAL2D_BF16_ATOL (a patch blended into another slice or
# place moves probabilities by tenths)
STACK_2D = (16, 512, 512, 1)
EVAL2D_BF16_ATOL = 0.05
# (d) tools/benchmark_loader.py, cut to a few cases and batches (of 2: an
# epoch drops its last partial batch, so 4 cases make no batch of 8)
LOADER_CASES, LOADER_SIZE, LOADER_BATCH, LOADER_BATCHES = 4, (96, 96, 48), 2, 4
LOADER_TIMEOUT = 300.0
# idle seconds at each end of a traced window, a try each: the profiler
# maps the card's kernel times onto the host clock, on the H100 machine now
# and then a millisecond or more off (a kernel before its launch call), and
# drops a kernel that then falls outside the window; one run lost 2 of 5
# launches six traces in a row with no idle time, another 4 of 5 with 20 ms
TRACE_PADS_S = (0.02, 0.1, 0.25, 0.5, 1.0, 2.0)
# phase 27: the probes' workdir is the 2D quickstart at full width, cut to
# a few steps and cases (the inventory of 8 cases at DropRatio 0.3 holds
# ~150 slices, above the 64 probe2d_r5c indexes); the A/B tags at 64^3,
# batch 96, one timed block after the first (tools/select_bench_tuning.py
# reads their log)
Q2D_STEPS = 4
Q2D_TRAIN = 8
AB_TAGS = ("base_b96_k4", "pdw_b96_k16")
AB_REPS = 1
AB_TIMEOUT = 300.0


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
    from vnet_tpu_torch.device import card_line
    from vnet_tpu_torch.ops import build

    name = torch.cuda.get_device_name(0)
    smi = card_line()
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
        f"{has['tensorboardX']} (the port writes its own event files)")
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
    mma = {name: ops for name, ops in
           tensor_core_ops(built[KERNELS.index("dw_conv")].path).items()
           if "dw_mma_kernel" in name and "bfloat16" in name}
    for fn, ops in sorted(mma.items()):
        say(f"[1] dw_conv SASS {fn}: {', '.join(sorted(ops)) or 'none'}")
    check(mma and all(mma.values()),
          "the bf16 dW kernels hold no HMMA or HGMMA instruction")
    dropout_sass(built[KERNELS.index("dropout")].path)
    return name, smi


def sass_instructions(library) -> dict:
    """``{kernel: [(opcode, operands)]}`` from ``cuobjdump --dump-sass`` of
    a built library (an opcode with its modifiers, e.g. ``IMAD.WIDE.U32``;
    predicates dropped)."""
    from vnet_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            name = text.split(":", 1)[1].strip()
            found[name] = []
        elif name is not None and text.startswith("/*") and "*/" in text:
            words = text.split("*/", 1)[1].split("/*")[0].split(None, 1)
            if words and words[0].startswith("@"):
                words = words[1].split(None, 1) if len(words) > 1 else []
            if words and words[0][0].isupper():
                found[name].append((words[0].rstrip(";"),
                                    words[1] if len(words) > 1 else ""))
    return found


def tensor_core_ops(library) -> dict:
    """``{kernel: {"HMMA", "HGMMA"} it holds}`` (HMMA is mma.sync, HGMMA
    wgmma)."""
    return {name: {op for op in ("HMMA", "HGMMA")
                   if any(o.split(".")[0] == op for o, _ in code)}
            for name, code in sass_instructions(library).items()}


# Philox4x32's round keys past the first: k + r * Weyl constant, r = 1..9
PHILOX_KEY_STEPS = {(r * w) % 2 ** 32 for r in range(1, 10)
                    for w in (0x9E3779B9, 0xBB67AE85)}


def dropout_sass(library) -> None:
    """The dropout kernels' SASS: no local memory (no spills), the
    32x32->64-bit multiplies (19 a Philox call: the first round's second
    product is 0), 16-byte loads and stores, and Philox's key schedule made
    once per loop, not once per call: each of the 18 round-key steps is
    added at most once for each of the kernel's two loops (vector and
    scalar), so the keys stay in registers across the calls."""
    steps = {f"{m:#x}" for m in PHILOX_KEY_STEPS} | {
        f"-{2 ** 32 - m:#x}" for m in PHILOX_KEY_STEPS}
    for name, code in sorted(sass_instructions(library).items()):
        if "dropout_kernel" not in name:
            continue

        def count(prefix, test=lambda op, args: True):
            return sum(op.split(".")[0] == prefix and test(op, args)
                       for op, args in code)

        local = count("STL") + count("LDL")
        wide = count("IMAD", lambda op, args: op == "IMAD.WIDE.U32")
        loads = count("LDG", lambda op, args: ".128" in op)
        stores = count("STG", lambda op, args: ".128" in op)
        key_adds = sum(any(t.strip(" ;") in steps for t in args.split(","))
                       for _, args in code)
        say(f"[1] dropout SASS {name}: IMAD.WIDE.U32 {wide}, round-key "
            f"adds {key_adds} (18 make the schedule once), local loads and "
            f"stores {local}, 16-byte loads {loads}, 16-byte stores "
            f"{stores}")
        check(local == 0, f"{name} uses local memory")
        check(wide >= 19 and stores >= 1,
              f"{name}: no Philox multiplies or no 16-byte stores")
        check(18 <= key_adds <= 36, f"{name}: the key schedule is made "
                                    f"{key_adds / 18:g} times")


def _kernel_vs_plain(acc_shape, patch, starts, gen, label, width,
                     tag="2"):
    """Blend kernel vs the plain slice-adds: bitwise equal, on the float
    path of ``width`` floats per element; times and the byte bound (each
    covered accumulator element read and written once, each contribution
    read once)."""
    from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                          blend_accumulate_plain)

    dev = torch.device("cuda", 0)
    b = starts.shape[0]
    acc0 = torch.rand(acc_shape, generator=gen, device=dev)
    contrib = torch.rand((b,) + tuple(patch) + (acc_shape[-1],),
                         generator=gen, device=dev)
    st = torch.from_numpy(np.ascontiguousarray(starts, np.int32))
    cover = torch.zeros(acc_shape[:3], dtype=torch.int32, device=dev)
    px, py, pz = patch
    for sx, sy, sz in st.tolist():
        cover[sx:sx + px, sy:sy + py, sz:sz + pz] += 1
    covered, depth = int((cover > 0).sum()), int(cover.max())
    del cover
    out_k = blend_accumulate_patches(acc0.clone(), contrib, st)
    got_width = blend_accumulate_patches.last_width
    out_p = blend_accumulate_plain(acc0.clone(), contrib, st)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    equal = torch.equal(out_k, out_p)
    del out_k, out_p
    acc_k, acc_p = acc0.clone(), acc0.clone()

    def call():
        blend_accumulate_patches(acc_k, contrib, st)

    call_ms = time_ms(call)
    plain_ms = time_ms(lambda: blend_accumulate_plain(acc_p, contrib, st))
    calls = 5
    spans, tries = _device_spans(call, "blend_accumulate_kernel", 1, calls,
                                 label)
    ms = statistics.median(t for name, t in spans
                           if "blend_accumulate_kernel" in name)
    nbytes = (2 * covered * acc_shape[-1] * 4 + contrib.nbytes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows = (starts.tolist() if b <= 16 else
            f"{b} rows, {starts[0].tolist()} to {starts[-1].tolist()}")
    say(f"[{tag}] {label}: acc {tuple(acc_shape)} contrib "
        f"{tuple(contrib.shape)} starts {rows}; {covered} covered "
        f"elements, up to {depth} patches over one")
    say(f"[{tag}] {label}: {'float4' if got_width == 4 else 'float'} path "
        f"(width {got_width}, expected {width}); bitwise_equal={equal} "
        f"max_abs_err={err:.3e}; kernel {ms:.4f} ms of device time "
        f"(profiler, median of {calls}, one launch a call in the trace, "
        f"try {tries}), {call_ms:.4f} ms per wrapper call "
        f"and plain {plain_ms:.4f} ms (CUDA events around each call, "
        f"median of 25); byte bound {bound_ms:.4f} ms "
        f"({nbytes / 1e9:.4f} GB), {bound_ms / ms:.1%} of it")
    check(equal, f"{label}: kernel differs from the plain version "
                 f"(max abs err {err})")
    check(got_width == width, f"{label}: the launch took the width "
                              f"{got_width} path, expected {width}")
    return err, ms, plain_ms, bound_ms, call_ms


def phase_kernel_vs_plain(card):
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, SLICE_STRIDE)
    check(len(grid) == 12, f"slice grid has {len(grid)} patches, expected 12")
    err, ms, plain_ms, bound_ms, call_ms = _kernel_vs_plain(
        SLICE_VOLUME + (4,), SLICE_PATCH, grid[:SLICE_BATCH], gen,
        f"slice shapes on {card}", 4)
    # ROADMAP Queue 1 #2: the LiTS geometry, stride 16 on every axis
    dense = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, (16, 16, 16))
    err_d = _kernel_vs_plain(SLICE_VOLUME + (4,), SLICE_PATCH,
                             dense[:SLICE_BATCH], gen, "dense stride 16",
                             4)[0]
    ragged_vol, ragged_patch = (97, 83, 45), (40, 33, 17)
    ragged = build_patch_grid(ragged_vol, ragged_patch, (23, 19, 11))
    err_r = _kernel_vs_plain(ragged_vol + (3,), ragged_patch, ragged[-7:],
                             gen, "ragged geometry", 1)[0]
    # the 2D evaluation's: (z, i, j) rows of depth-1 blocks
    grid = build_patch_grid(SLICE_VOLUME[:2], PATCH_2D, EVAL_STRIDE_2D)
    rows = np.concatenate(
        [np.repeat(np.arange(SLICE_VOLUME[2], dtype=np.int32),
                   len(grid))[:, None],
         np.tile(grid, (SLICE_VOLUME[2], 1))], axis=-1)[:SLICE_BATCH]
    stack = (SLICE_VOLUME[2],) + SLICE_VOLUME[:2]
    c = 3  # blend weight and config_2d.json's two classes
    width = _blend_width(stack[2], PATCH_2D[1], rows[:, 2].tolist(), c)
    err_2d, ms_2d, plain_2d, bound_2d, call_2d = _kernel_vs_plain(
        stack + (c,), (1,) + PATCH_2D, rows, gen, "slice-stacked 2D geometry",
        width)
    blend = dict(max_abs_err=max(err, err_d, err_r), ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                 library_ms=None, share_of_bound=bound_ms / ms,
                 call_ms=call_ms)
    blend_2d = dict(max_abs_err=err_2d, ms=ms_2d, plain_ms=plain_2d,
                    bound_ms=bound_2d, bound_by="bytes", library_ms=None,
                    call_ms=call_2d)
    return blend, blend_2d


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
    counts = held_bn(read_counts(), "4")
    launches = counts["blend_accumulate"]
    width = _counted()["blend_accumulate"].last_width

    say(f"[4] main path: {len(results)} cases in {wall:.2f} s "
        f"({wall / 2:.2f} s per case incl. model build, checkpoint load and "
        f"first-call warm-up); blend launches {launches}, batches "
        f"{2 * n_batches_per_case}, float path width {width}")
    check(len(results) == 2, f"{len(results)} labels written, expected 2")
    check(launches == 2 * n_batches_per_case,
          "blend kernel launches != patch batches")
    check(launches == sum(counts.values()),
          f"evaluation launched other kernels: {counts}")
    check(width == 4, f"the evaluation's blend took the width {width} path")
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
    from vnet_tpu_torch.ops.bn_act import (bn_act_apply, bn_act_dx,
                                           bn_act_grad_sums)
    from vnet_tpu_torch.ops.dropout import dropout_apply
    from vnet_tpu_torch.ops.dw_conv import dw_conv
    from vnet_tpu_torch.ops.fused import (bn_grad_stats, bn_stats,
                                          fused_bias_prelu_residual)

    return {"blend_accumulate": blend_accumulate_patches,
            "dropout": dropout_apply, "dw_conv": dw_conv,
            "bn_stats": bn_stats, "bn_grad_stats": bn_grad_stats,
            "bias_prelu_residual": fused_bias_prelu_residual,
            "blend_rows": blend_accumulate_rows,
            "bn_act_apply": bn_act_apply,
            "bn_act_grad_sums": bn_act_grad_sums, "bn_act_dx": bn_act_dx}


# the wrappers a batch norm launches on the card: its forward's sums
# (ops/fused.py's bn_stats, which phase 9 also calls itself), the apply,
# the gradient sums and dx (ops/bn_act.py)
BN_ACT = ("bn_stats", "bn_act_apply", "bn_act_grad_sums", "bn_act_dx")
# what the batch-norm calls since reset_counts owe each of them
_OWED = dict.fromkeys(BN_ACT, 0)
_HOOKED = []


def _hook_norms() -> None:
    """Forward hooks on every module of the process (once): a ``BatchNorm``
    call on the card, outside ``torch.export``'s trace, owes the apply one
    launch and, with the batch's statistics, the sums one (counted before
    the call: a ``Remat`` recompute may stop inside a call, once the
    Function has launched both); each time autograd takes its output's
    gradient (it runs the Function's backward then; never for a
    recompute's output, whose backward is the forward's), the gradient sums
    one and, where the input needs a gradient, dx one."""
    if _HOOKED:
        return
    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    from vnet_tpu_torch.models.layers import BatchNorm

    def counted(module, args) -> bool:
        return (isinstance(module, BatchNorm) and args[0].is_cuda
                and not torch.compiler.is_compiling())

    def owe_forward(module, args):
        if counted(module, args):
            _OWED["bn_act_apply"] += 1
            _OWED["bn_stats"] += not args[1]

    def owe_backward(module, args, out):
        if counted(module, args) and out.requires_grad:
            dx = args[0].requires_grad

            def backward(grad):
                _OWED["bn_act_grad_sums"] += 1
                _OWED["bn_act_dx"] += dx

            out.register_hook(backward)

    _HOOKED.extend([register_module_forward_pre_hook(owe_forward),
                    register_module_forward_hook(owe_backward)])


def reset_counts() -> None:
    _hook_norms()
    for wrapper in _counted().values():
        wrapper.launches = 0
    _OWED.update(dict.fromkeys(BN_ACT, 0))


def read_counts() -> dict:
    return {name: w.launches for name, w in _counted().items()}


def held_bn(counts: dict, tag: str, **own) -> dict:
    """``counts`` (a :func:`read_counts` reading) without the batch-norm
    wrappers, once their launches equal what the batch-norm calls since
    :func:`reset_counts` owe them (``own``: a wrapper's launches by the
    phase's own calls beside them)."""
    got = {k: counts[k] for k in BN_ACT}
    owed = {k: v + own.get(k, 0) for k, v in _OWED.items()}
    check(got == owed, f"[{tag}] batch-norm launches {got}, owed {owed} by "
                       f"the batch-norm calls")
    return {k: v for k, v in counts.items() if k not in BN_ACT}


def phase_dropout_times():
    """``tools/dropout_bench.py`` in a process of its own (a fresh
    profiler: after many traces in one process, later traces can hold no
    device events): every dropout shape of the three training steps, timed
    as the module says; ``(rows, sums)``."""
    out = os.path.join(tempfile.mkdtemp(prefix="vnet_smoke_drop_"),
                       "dropout_bench.json")
    cmd = [sys.executable, "-m", "vnet_tpu_torch.tools.dropout_bench",
           "--out", out]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    if proc.returncode != 0:
        for line in tail:
            say(f"[17]   {line}")
    # the tail also goes into the error, which stderr keeps
    check(proc.returncode == 0, "dropout_bench failed:\n" + "\n".join(tail))
    with open(out) as f:
        bench = json.load(f)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    for row in bench["rows"]:
        lib = row["F.dropout"]
        say(f"[17] dropout {row['impl']} {tuple(row['shape'])} bf16 "
            f"channels-last: device {row['device_ms']:.4f} ms a launch "
            f"(profiler median; {row['bound_ms'] / row['device_ms']:.1%} of "
            f"the {row['bound_ms']:.4f} ms byte bound), events "
            f"{row['event_ms']:.4f} ms a launch over {bench['launches']}+ "
            f"launches, {row['call_ms']:.4f} ms per wrapper call (events "
            f"around one call, host time included), wrapper "
            f"{row['host_us']:.1f} us of host time a call;"
            f" F.dropout device {lib['device_ms']:.4f} ms, events "
            f"{lib['event_ms']:.4f} ms")
    for name, e in bench["sums"].items():
        say(f"[17] dropout in a {name} step: {e['launches']} launches, "
            f"device {e['device_ms']:.4f} ms against a bound of "
            f"{e['bound_ms']:.4f} ms, F.dropout {e['library_device_ms']:.4f}"
            f" ms")
    libs = {tuple(r["shape"]): r["F.dropout"] for r in bench["rows"]}
    retakes = (sum(r["retakes"] for r in bench["rows"])
               + sum(lib["retakes"] for lib in libs.values()))
    say(f"[17] dropout_bench in {time.perf_counter() - t0:.1f} s "
        f"({bench['card']}); profiler traces taken again after a refusal: "
        f"{retakes}")
    rows = [dict(shape=r["shape"], impl=r["impl"], device_ms=r["device_ms"],
                 event_ms=r["event_ms"], call_ms=r["call_ms"],
                 host_us=r["host_us"],
                 bound_ms=r["bound_ms"],
                 library_device_ms=r["F.dropout"]["device_ms"],
                 library_event_ms=r["F.dropout"]["event_ms"])
            for r in bench["rows"]]
    return rows, bench["sums"]


def _dropout_equal(shape, impls, gen, seed, stream, tag, dtype=None):
    """Kernel vs plain, bitwise, at one channels-last shape (``xla``
    survivors also ``x / keep_d`` rounded once); ``max |diff|``."""
    from vnet_tpu_torch.ops.dropout import (dropout_apply, dropout_params,
                                            dropout_plain)

    fmt = (torch.channels_last_3d if len(shape) == 5
           else torch.channels_last)
    x = (torch.randn(shape, generator=gen, device="cuda") * 30.0).to(
        dtype or torch.bfloat16).contiguous(memory_format=fmt)
    err = 0.0
    for impl in impls:
        params = dropout_params(0.01, impl)
        out_k = dropout_apply(x, seed, stream, *params)
        out_p = dropout_plain(x, seed, stream, *params)
        torch.cuda.synchronize()
        equal = torch.equal(out_k, out_p)
        err = max(err, (out_k.float() - out_p.float()).abs().max().item())
        quotient = True
        if impl == "xla":
            keep_d = torch.tensor(params[1], dtype=x.dtype).float().cuda()
            kept = out_k != 0
            quotient = torch.equal(out_k[kept],
                                   (x.float() / keep_d).to(x.dtype)[kept])
        say(f"{tag} dropout {impl} {shape}: kernel bitwise_equal={equal}"
            + (f", survivors x / keep_d rounded once={quotient}"
               if impl == "xla" else ""))
        check(equal, f"dropout {impl} {shape}: kernel differs from plain")
        check(quotient, f"dropout xla {shape}: survivors != x / keep_d")
        del out_k, out_p
    del x
    torch.cuda.empty_cache()
    return err


def _division_sweep():
    """Every float32 bit pattern through the ``xla`` kernel, in 2^30-element
    calls, at threshold 2^32 - 1 and ``keep_d`` of each rate: each output's
    bits equal the plain division's (NaNs as NaN), except where the
    element's word is 2^32 - 1 and the output is +0 (dropped)."""
    from vnet_tpu_torch.ops.dropout import (dropout_apply, dropout_params,
                                            philox4x32_10)

    thr, chunk, seed, stream = 2 ** 32 - 1, 1 << 30, 20261018, 5
    t0 = time.perf_counter()
    result = {}
    for rate in (0.01, 0.1, 0.3, 0.5, 0.9):
        _, keep, divide = dropout_params(rate, "xla")
        keep_d = torch.tensor(keep, dtype=torch.float32, device="cuda")
        wrong = dropped = 0
        for c in range(4):
            x = torch.arange(chunk, dtype=torch.int32, device="cuda").add_(
                -2 ** 31 + c * chunk).view(torch.float32)
            out = dropout_apply(x, seed, stream, thr, keep, divide)
            expect = x / keep_d
            bad = ((out.view(torch.int32) != expect.view(torch.int32))
                   & ~(out.isnan() & expect.isnan())).nonzero().flatten()
            if bad.numel():
                words = philox4x32_10(bad // 4, seed, stream)
                word = words.gather(1, (bad % 4)[:, None]).flatten()
                drop = (word == thr) & (out[bad].view(torch.int32) == 0)
                dropped += int(drop.sum())
                wrong += int((~drop).sum())
            del x, out, expect, bad
        result[rate] = (wrong, dropped)
    torch.cuda.empty_cache()
    say(f"[5] division sweep, all 2^32 float32 patterns at threshold 2^32 - 1 "
        f"in 2^30-element launches: (mismatches, dropped) by rate "
        f"{result} in {time.perf_counter() - t0:.1f} s")
    check(all(w == 0 for w, _ in result.values()),
          f"the kernel's division differs from the plain one: {result}")
    return result


def phase_dropout():
    """Dropout kernel vs plain at every dropout shape of the flagship and
    attention steps, and the division sweep (phase 17 times them)."""
    from vnet_tpu_torch.ops.dropout import (dropout, dropout_apply,
                                            dropout_params, dropout_plain)
    from vnet_tpu_torch.tools.dropout_bench import dropout_shapes

    rate, seed, stream = 0.01, 20261016, 3
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(FLAGSHIP_DROP, generator=gen,
                    device="cuda").to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last_3d)
    nonzero = x != 0
    n = int(nonzero.sum())
    for impl in ("pallas", "bits8"):
        params = dropout_params(rate, impl)
        thr = params[0]
        out_k = dropout_apply(x, seed, stream, *params)
        out_p = dropout_plain(x, seed, stream, *params)
        torch.cuda.synchronize()
        equal = torch.equal(out_k, out_p)
        p = thr / 2.0 ** 32
        kept = int(((out_k != 0) & nonzero).sum())
        sigmas = abs(kept - n * p) / (n * p * (1 - p)) ** 0.5
        del out_p
        xr = x.detach().requires_grad_()
        y = dropout(xr, seed, stream, rate, impl)
        g = torch.ones(y.shape, dtype=y.dtype, device="cuda")  # not CL
        (dx,) = torch.autograd.grad(y, xr, g)
        same_mask = bool((((dx != 0) == (y != 0)) | ~nonzero).all())
        del xr, y, g, dx, out_k
        say(f"[5] dropout {impl} {tuple(x.shape)} bf16 channels-last: "
            f"bitwise_equal={equal} keep {kept / n:.6f} (p {p:.6f}, "
            f"{sigmas:.2f} sigma) backward_mask_equal={same_mask}")
        check(equal, f"dropout {impl}: kernel differs from the plain version")
        check(sigmas < 5.0, f"dropout {impl}: keep fraction off by "
                            f"{sigmas:.1f} sigma")
        check(same_mask, f"dropout {impl}: backward mask != forward mask")
    params = dropout_params(rate, "xla")
    plain_ms = time_ms(lambda: dropout_plain(x, seed, stream, *params),
                       reps=3)
    del x, nonzero
    torch.cuda.empty_cache()
    flagship = [s for s, _ in dropout_shapes("flagship")]
    heads = [s for s, _ in dropout_shapes("attention") if s[0] == ATT_BATCH
             and s[1] == ATT_CHANNELS and s[2:] == TRAIN_PATCH]
    check(len(flagship) == 5 and len(heads) == 1,
          f"dropout shapes: {flagship}, heads {heads}")
    err = max(_dropout_equal(s, ("pallas", "xla"), gen, seed, stream, "[5]")
              for s in flagship)
    for shape in [s for s, _ in dropout_shapes("attention")]:
        _dropout_equal(shape, ("xla",), gen, seed, stream, "[5]")
    _dropout_ragged(gen, seed, stream)
    _division_sweep()
    return dict(max_abs_err=err, plain_ms=plain_ms)


def _dropout_ragged(gen, seed, stream):
    """A ragged, unaligned float32 length (the kernel's scalar path) and a
    bf16 one: ``xla`` kernel bitwise equal to plain, survivors
    ``x / keep_d`` rounded once."""
    from vnet_tpu_torch.ops.dropout import (dropout_apply, dropout_params,
                                            dropout_plain)

    params = dropout_params(0.01, "xla")
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(1000004, generator=gen, device="cuda")
             * 30.0).to(dtype)[1:]  # one element off 16-byte alignment
        out_k = dropout_apply(x, seed, stream, *params)
        out_p = dropout_plain(x, seed, stream, *params)
        keep_d = torch.tensor(params[1], dtype=dtype).float().cuda()
        kept = out_k != 0
        equal = torch.equal(out_k, out_p)
        quotient = torch.equal(out_k[kept], (x.float() / keep_d).to(dtype)[
            kept])
        say(f"[5] dropout xla ragged unaligned ({x.numel()},) {dtype}: "
            f"bitwise_equal={equal} survivors x / keep_d rounded once="
            f"{quotient}, kept {kept.float().mean().item():.6f}")
        check(equal, f"dropout xla ragged {dtype}: kernel differs from plain")
        check(quotient, f"dropout xla ragged {dtype}: survivors != x/keep_d")


DW_EDGE = (  # (B, Ci, Co, (X, Y, Z), k, dtype, g channels-last)
    (3, 16, 16, (9, 11, 13), 5, torch.bfloat16, True),   # ragged, narrow
    (2, 64, 32, (7, 5, 9), 5, torch.bfloat16, True),     # ragged, wide
    (4, 32, 16, (16, 16, 16), 5, torch.float16, True),
    (2, 16, 16, (8, 8, 8), 5, torch.float32, True),      # CUDA cores
    (2, 16, 32, (12, 10, 16), 3, torch.bfloat16, False),
    (2, 32, 16, (10, 10, 10), 1, torch.bfloat16, True),
    (1, 16, 16, (6, 6, 6), 7, torch.bfloat16, True))


def _dw_agree(x, g, ks, label):
    """Kernel vs plain within DW_RTOL * max|dW| and two kernel runs
    bitwise equal; returns (max |diff|, max |dW|)."""
    from vnet_tpu_torch.ops.dw_conv import dw_conv, dw_conv_plain

    out_k = dw_conv(x, g, ks)
    out_k2 = dw_conv(x, g, ks)
    out_p = dw_conv_plain(x, g, ks)
    torch.cuda.synchronize()
    same = torch.equal(out_k, out_k2)
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    check(err <= DW_RTOL * scale,
          f"dW {label}: kernel differs from the plain version ({err:.3e} "
          f"against max|dW| {scale:.3e})")
    check(same, f"dW {label}: two kernel runs differ")
    return err, scale


def _dw_shape(ci, co, vol, ks, n, gen, timed, prefix):
    """One of a step's weight-gradient shapes at batch 96: the kernel held
    against its plain version; with ``timed``, kernel, plain and cuDNN ms
    and the bound. Returns the row of numbers."""
    from vnet_tpu_torch.ops.dw_conv import dw_conv, dw_conv_plain, plan
    from vnet_tpu_torch.tools.dw_bench import step_bound_ms

    cl = torch.channels_last_3d
    x = torch.randn((FLAGSHIP_BATCH, ci) + vol, generator=gen,
                    device="cuda").to(torch.bfloat16).contiguous(
                        memory_format=cl)
    g = torch.randn((FLAGSHIP_BATCH, co) + vol, generator=gen,
                    device="cuda").to(torch.bfloat16).contiguous(
                        memory_format=cl)
    p = plan(FLAGSHIP_BATCH, vol, ci, co, ks, x.dtype)
    label = f"{ci}->{co} k{ks} at {vol}"
    err, scale = _dw_agree(x, g, ks, label)
    w = torch.empty((co, ci) + ks, dtype=torch.bfloat16, device="cuda")
    pad = tuple((k - 1) // 2 for k in ks)
    bound_ms, flops, nbytes = step_bound_ms(
        ci, co, vol, ks, FLAGSHIP_BATCH, BF16_FLOPS, HBM_BYTES_PER_S)
    row = dict(max_abs_err=err, bound_ms=bound_ms, flops=flops,
               bytes=nbytes)
    if timed:
        row["ms"] = time_ms(lambda: dw_conv(x, g, ks), reps=5)
        row["plain_ms"] = time_ms(lambda: dw_conv_plain(x, g, ks), reps=1,
                                  warmup=False)
        row["library_ms"] = time_ms(lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, (1, 1, 1), pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False)), reps=5)
    times = (f"kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
             f"TFLOP/s) plain {row['plain_ms']:.3f} ms cuDNN "
             f"{row['library_ms']:.3f} ms " if timed else "")
    say(f"{prefix} dW {label} batch {FLAGSHIP_BATCH} bf16, x{n} per step, "
        f"{p.regime} (tiles {p.tiles} brick {p.brick} ry {p.ry} chunks "
        f"{p.chunks}): max|diff| {err:.3e} max|dW| {scale:.3e} "
        f"({err / scale:.2e} of it, tolerance {DW_RTOL:g}), bitwise run to "
        f"run; {times}bound {bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP, "
        f"{nbytes / 1e9:.3f} GB)")
    del x, g, w
    torch.cuda.empty_cache()
    return row


def phase_dw():
    """dW kernel vs plain at the packed flagship step's nine weight-gradient
    shapes (timed; the kernels line reports the step-weighted sums,
    launches per step x ms), at the direct step's ten (held, not timed) and
    at edge cases."""
    from vnet_tpu_torch.ops.dw_conv import plan
    from vnet_tpu_torch.tools.dw_bench import dw_shapes

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cl = torch.channels_last_3d
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, flops=0.0, bytes=0.0)
    packed = dw_shapes("packed")
    check(len(packed) == 9 and sum(s[-1] for s in packed) == 21,
          f"packed dW shapes {packed}")
    for ci, co, vol, ks, n in packed:
        row = _dw_shape(ci, co, vol, ks, n, gen, True, "[6] packed")
        total["max_abs_err"] = max(total["max_abs_err"], row["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                    "bytes"):
            total[key] += n * row[key]
    bound_by = ("operations" if total["flops"] / BF16_FLOPS
                > total["bytes"] / HBM_BYTES_PER_S else "bytes")
    say(f"[6] dW per packed step (21 launches, launches x ms over the nine "
        f"shapes): kernel {total['ms']:.3f} ms, cuDNN "
        f"{total['library_ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"bound {total['bound_ms']:.4f} ms ({bound_by}, "
        f"{total['flops'] / 1e12:.3f} TFLOP)")
    direct = dw_shapes("direct")
    check(len(direct) == 10 and sum(s[-1] for s in direct) == 22,
          f"direct dW shapes {direct}")
    for ci, co, vol, ks, n in direct:
        _dw_shape(ci, co, vol, ks, n, gen, False, "[6] direct")
    for b, ci, co, vol, k, dtype, g_cl in DW_EDGE:
        x = torch.randn((b, ci) + vol, generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=cl)
        g = torch.randn((b, co) + vol, generator=gen, device="cuda").to(dtype)
        if g_cl:
            g = g.contiguous(memory_format=cl)
        ks = (k,) * 3
        p = plan(b, vol, ci, co, ks, dtype)
        label = (f"{ci}->{co} k{k} {dtype} batch {b} {vol}"
                 f"{'' if g_cl else ', g not channels-last'}")
        err, scale = _dw_agree(x, g, ks, label)
        say(f"[6] dW edge case {label}, {p.regime}: max|diff| {err:.3e} "
            f"({err / scale:.2e} of max|dW|), bitwise run to run")
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
    """The training main path through the CLI's ``main`` at ``--devices
    0``: on one card a process group of one rank under ``nccl``."""
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.io import MedicalImage, write_image
    from vnet_tpu_torch.tools.dw_bench import dw_shapes
    from vnet_tpu_torch.tools.profile_step import count_collectives
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

    groups, restore_groups = _spy_groups()
    collectives, restore = count_collectives()
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = main(["-p", "train", "--config_json", cfg_path,
                      "--device", "cuda", "--devices", "0"])
        torch.cuda.synchronize()
    finally:
        restore()
        restore_groups()
    wall = time.perf_counter() - t0
    raw = read_counts()
    counts = held_bn(raw, "7")
    bn_launches = {k: raw[k] for k in BN_ACT}
    say(f"[7] --devices 0 on {torch.cuda.device_count()} card(s): process "
        f"groups (backend, world size) {groups}, collectives called "
        f"{dict(collectives)}")
    check(groups == [("nccl", 1)], f"expected one nccl group of one rank, "
                                   f"got {groups}")
    check(not collectives, f"world size 1 called collectives {collectives}")

    steps = ts["MaxIterations"]
    n_dropout = len(state.network.dropouts)
    # the module tree's weight gradients on the dW kernel at this patch
    n_dw = sum(s[-1] for s in dw_shapes("packed", TRAIN_PATCH))
    with open(os.path.join(ts["LogDir"], "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    say(f"[7] train main path: {steps} steps at batch {ts['BatchSize']}, "
        f"patch {TRAIN_PATCH}, in {wall:.2f} s (incl. data loading, model "
        f"build, first-call warm-up, checkpoints); losses {losses}; "
        f"launches {counts}, batch norm {bn_launches}; module tree: "
        f"{n_dropout} dropout layers, {n_dw} weight gradients on the dW "
        f"kernel (packed)")
    check(state.step == steps, f"trained {state.step} steps, not {steps}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    check(type(state.network).__name__ == "VNet"
          and state.network.conv_impl == "packed",
          "the trainer did not build the packed VNet")
    check(n_dropout == 21 and n_dw == 21,
          f"module tree: {n_dropout} dropouts, {n_dw} dW launches a step")
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
    return counts, bn_launches


def _spy_groups():
    """Record ``(backend, world size)`` of every process group this process
    starts; returns ``(records, restore)``."""
    import torch.distributed as dist

    real, seen = dist.init_process_group, []

    def spy(backend=None, *args, **kwargs):
        seen.append((backend, kwargs.get("world_size")))
        return real(backend, *args, **kwargs)

    dist.init_process_group = spy
    return seen, lambda: setattr(dist, "init_process_group", real)


def _flagship_steps(impl, batch, conv_impl, remat=False):
    from vnet_tpu_torch.tools.profile_step import flagship_step, timed_steps

    state, step, images, labels = flagship_step(impl, batch, seed=SEED,
                                                conv_impl=conv_impl,
                                                remat=remat)
    torch.cuda.reset_peak_memory_stats()
    timed_steps(state, step, images, labels, 1)  # warm-up
    reset_counts()
    times, losses = timed_steps(state, step, images, labels, 3)
    counts = held_bn(read_counts(), "8")
    return (statistics.median(times), torch.cuda.max_memory_allocated(),
            losses, {k: v / 3 for k, v in counts.items() if v})


def phase_flagship():
    """``bench.py``'s flagship step (batch 96, 64^3): the packed network
    (as the trainer and ``bench.py`` build it) beside the direct one, each
    with the kernels and with the library's dropout and dW."""
    result = {}
    for impl in ("pallas", "xla"):
        for conv_impl in ("packed", "direct"):
            batch = FLAGSHIP_BATCH
            while True:
                try:
                    ms, peak, losses, per_step = _flagship_steps(
                        impl, batch, conv_impl)
                    break
                except torch.cuda.OutOfMemoryError:
                    torch.cuda.empty_cache()
                    say(f"[8] {conv_impl} {impl}: batch {batch} does not "
                        f"fit in memory")
                    check(batch > 8, "not even batch 8 fits")
                    batch //= 2
            torch.cuda.empty_cache()
            say(f"[8] flagship step, {conv_impl}, DropoutImpl/DwImpl {impl}: "
                f"batch {batch} 64^3 bf16: median {ms:.1f} ms per step "
                f"(3 steps after a warm-up), {batch / ms * 1e3:.1f} "
                f"patches/s, peak memory {peak / 2 ** 30:.2f} GiB; losses "
                f"{losses}; kernel launches a step {per_step}")
            check(all(np.isfinite(losses)), f"flagship losses {losses}")
            if impl == "pallas":
                expect = ({"dropout": 42, "dw_conv": 21}
                          if conv_impl == "packed"
                          else {"dropout": 42, "dw_conv": 22})
                check(per_step == expect, f"{conv_impl} flagship launches "
                                          f"{per_step}, expected {expect}")
            result[(conv_impl, impl)] = (batch, ms)
    say("[8] packed vs direct, same process: " + ", ".join(
        f"{impl} {result[('packed', impl)][1]:.1f} vs "
        f"{result[('direct', impl)][1]:.1f} ms" for impl in ("pallas", "xla")))
    return result


def _train_and_grads(net, x, cot):
    """One training-mode forward of ``net`` on ``x``, ``sum(out * cot)``
    backward: logits, parameter gradients, running averages."""
    net.train()
    for p in net.parameters():
        p.grad = None
    out = net(x, dropout_seed=0)
    (out * cot).sum().backward()
    grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
    stats = {k: v.clone() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return out.detach(), grads, stats


def _max_rel(got, ref) -> float:
    """max |got - ref| over a kind's tensors, relative to its largest
    |ref| entry."""
    scale = max(v.abs().max().item() for v in ref.values())
    return max((got[k] - v).abs().max().item() for k, v in ref.items()) / scale


def phase_packed_vs_direct():
    """The packed network against the direct one on the card (phase 18):
    float32 with TF32 off, 8 channels, 2 levels, 16^3 (2D: 32^2),
    PackedTargetLanes 64 (levels (2, 2, 2), (2, 2, 1) and a (2, 1, 1)
    bottom in 3D), DwImpl pallas (the dW kernel's float32 path on the
    packed shapes): logits, every parameter gradient and the running
    averages of one training step, 3D with one and two input channels and
    2D. At 3 levels and 32^3 the two computations' gradients differ by
    more than PACKED_RTOL of the largest on the CPU, in JAX as in the port:
    batch norm's E[x^2] - E[x]^2 over other summation orders (PERF.md); at
    this size they agree well inside it."""
    from vnet_tpu_torch.models import build_network

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    for rank, patch, in_ch in ((3, (16, 16, 16), 1), (3, (16, 16, 16), 2),
                               (2, (32, 32), 1)):
        kw = dict(num_classes=3, in_channels=in_ch, num_channels=8,
                  num_levels=2, num_convolutions=(1, 2),
                  bottom_convolutions=2, dropout_rate=0.0, device="cuda",
                  dw_impl="pallas", spatial_rank=rank,
                  packed_target_lanes=64,
                  generator=torch.Generator().manual_seed(SEED))
        packed = build_network("VNet", **kw)
        direct = build_network("VNet", conv_impl="direct", **kw)
        direct.load_state_dict(packed.state_dict())
        x = torch.from_numpy(rng.normal(50.0, 20.0, size=(2,) + patch + (
            in_ch,)).astype(np.float32)).cuda()
        cot = torch.from_numpy(rng.normal(size=(2,) + patch + (3,)).astype(
            np.float32)).cuda()
        reset_counts()
        out_p, grads_p, stats_p = _train_and_grads(packed, x, cot)
        launches = read_counts()["dw_conv"]
        out_d, grads_d, stats_d = _train_and_grads(direct, x, cot)
        errs = (_max_rel({"": out_p}, {"": out_d}), _max_rel(grads_p, grads_d),
                _max_rel(stats_p, stats_d))
        plan = packed.plan(patch)
        levels = [f if ok else None for ok, f in
                  plan["encoder"] + [plan["bottom"]]]
        say(f"[18] packed vs direct, f32 TF32 off, {rank}D patch {patch} "
            f"{in_ch} input channel(s), levels {levels}: max|diff| / max "
            f"logits {errs[0]:.2e}, gradients {errs[1]:.2e}, running "
            f"averages {errs[2]:.2e} (tolerance {PACKED_RTOL:g}); dW kernel "
            f"launches of the packed step {launches}")
        check(bool(torch.isfinite(out_p).all()), "packed logits not finite")
        check(max(errs) <= PACKED_RTOL,
              f"packed and direct differ on the card: {errs}")
        check(rank == 2 or launches > 0, "the packed step launched no dW")
        del packed, direct
    torch.cuda.empty_cache()


def phase_zoo(tmp):
    """One training step and one evaluation on the card for each name this
    port added to the zoo (phase 19): ``configs/config.json``'s network
    settings with ``Name`` UNet, Dense and VNetLegacy, bf16, batch 2 at
    64^3 (Dense at 32^3: one output unit per voxel and class), through
    ``Trainer.train_step`` and ``Evaluator.evaluate_case`` on a synthetic
    96x96x80 case; VNetLegacy with the kernels (``pallas``: 42 dropout and
    21 dW launches a step), UNet and Dense with the ``xla`` flavour (flax's
    dropout, which their JAX modules take), launched twice a layer."""
    import yaml

    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.infer.evaluator import Evaluator
    from vnet_tpu_torch.io import MedicalImage, write_image
    from vnet_tpu_torch.train import Trainer

    rng = np.random.default_rng(SEED)
    img, _ = _train_case(rng)
    case_dir = os.path.join(tmp, "evaluate", "case_0")
    os.makedirs(case_dir)
    write_image(MedicalImage(img, (0.75,) * 3),
                os.path.join(case_dir, "image.nii"))
    for name, patch in (("UNet", TRAIN_PATCH), ("Dense", (32, 32, 32)),
                        ("VNetLegacy", TRAIN_PATCH)):
        with open(TRAIN_CONFIG) as f:
            cfg = json.load(f)
        ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
        pipeline = os.path.join(tmp, "pipeline.yaml")
        crop = {"output_size": list(patch)}
        with open(pipeline, "w") as f:
            yaml.safe_dump({"preprocess": {"evaluate": {"3D": [
                {"name": "StatisticalNormalization",
                 "variables": {"sigma": 2.5}},
                {"name": "Padding", "variables": crop}]}}}, f)
        kernels = name == "VNetLegacy"
        ts["Networks"].update(Name=name,
                              DropoutImpl="pallas" if kernels else "xla",
                              DwImpl="pallas" if kernels else "xla")
        ts.update(PatchShape=list(patch), BatchSize=2, Pipeline=pipeline,
                  LogDir=os.path.join(tmp, "log"),
                  CheckpointDir=os.path.join(tmp, "ckpt"))
        es.update(Stride=list(patch), BatchSize=2, Pipeline=pipeline,
                  CheckpointPath=ts["CheckpointDir"])
        es["Data"]["EvaluateDataDirectory"] = os.path.join(tmp, "evaluate")
        path = os.path.join(tmp, f"config_{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
        trainer = Trainer(load_config(path), device="cuda", log=False)
        net = trainer.network
        check(type(net).__name__ == ("VNet" if kernels else name),
              f"{name} built {type(net).__name__}")
        shape = (2,) + patch
        images = rng.normal(0.0, 1.0, size=shape + (1,)).astype(np.float32)
        labels = rng.integers(0, 3, size=shape).astype(np.int32)
        state = trainer.init_state()
        trainer.train_step(state, images, labels, 7)  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.train_step(state, images, labels, 8)
        loss = float(out.loss)
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in held_bn(read_counts(), "19").items()
                  if v}
        evaluator = Evaluator(load_config(path),
                              state_dict=net.state_dict(), device="cuda")
        t0 = time.perf_counter()
        written, probs = evaluator.evaluate_case(case_dir)
        eval_s = time.perf_counter() - t0
        labels_out = set(np.unique(np.asarray(written.data)).tolist())
        finite = all(bool(np.isfinite(np.asarray(pr.data)).all())
                     for pr in probs)
        say(f"[19] {name} (config.json settings, bf16, batch 2, patch "
            f"{patch}): train step {step_ms:.1f} ms (host clock, after a "
            f"warm-up), loss {loss:.5f}, launches {counts}; evaluation of "
            f"a {TRAIN_CASE} case {eval_s:.2f} s: labels {sorted(labels_out)}"
            f", {len(probs)} probability maps, finite {finite}")
        check(np.isfinite(loss), f"{name}: loss {loss}")
        check(labels_out <= {0, 1, 2}, f"{name}: labels {labels_out}")
        check(len(probs) == 3 and finite,
              f"{name}: probability maps not finite")
        check(tuple(written.data.shape) == TRAIN_CASE,
              f"{name}: label shape {written.data.shape}")
        # every dropout flavour runs the kernel on the card: each layer
        # launches it forward and backward
        expect = {"dropout": 2 * len(net.dropouts)}
        if kernels:
            expect["dw_conv"] = 21
            check(len(net.dropouts) == 21, "VNetLegacy dropout layers")
        check(counts == expect, f"{name} step launches {counts}, expected "
                                f"{expect}")
        del trainer, evaluator, state, net
        torch.cuda.empty_cache()


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
    held_bn(counts, "9", bn_stats=3)
    check(counts["bn_grad_stats"] == 3,
          f"batch_norm_train pallas launched {counts}")
    return ([dict(t, bound_by="bytes") for t in totals],
            (counts["bn_stats"] - _OWED["bn_stats"],
             counts["bn_grad_stats"]))


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


def _device_spans(fn, kernel: str, per_call: int, calls: int, label: str):
    """``([(name, ms)], tries)``: the device events of ``calls`` calls of
    ``fn`` from a ``torch.profiler`` trace, which must hold ``per_call``
    events of ``kernel`` (a name fragment) a call, as the launch count says.
    A trace can miss device events (a cold one often; one whose kernels
    the profiler places outside its window, which the idle time of
    ``TRACE_PADS_S`` at each end, longer at each try, guards against), so
    each try starts with an untimed trace of one call, and a trace whose
    count differs is taken again, six tries in all: a kernel that runs
    another number of times fails every one. The failure lists each try's
    count and its kernels' starts in ms from the first launch call's."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    missed = []
    for tries, pad in enumerate(TRACE_PADS_S, 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts):
            fn()
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        found = sum(kernel in name for name, _ in spans)
        if found == per_call * calls:
            return spans, tries
        first = min((e.time_range.start for e in events
                     if "LaunchKernel" in e.name), default=0)
        missed.append((found, [round((e.time_range.start - first) / 1e3, 2)
                               for e in events if kernel in e.name
                               and e.device_type
                               == torch.autograd.DeviceType.CUDA]))
    check(False, f"{label}: the traces show {missed} (count, starts) "
                 f"{kernel} events in {calls} calls, the count {per_call} "
                 f"a call")


def _rows_case(big_r, c, starts, window, gen, label):
    """Row blend vs its plain loop: bitwise equal in one launch (the count
    and the trace agree); the copy of the starts, the plan's kernels and
    the accumulate kernel timed apart from the trace, the whole call by the
    host clock."""
    from vnet_tpu_torch.ops.blend import (blend_accumulate_rows,
                                          blend_accumulate_rows_plain)

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
    del acc_p, w_p
    check(launches == 1, f"row blend {label}: {launches} launches in one "
                         f"call")

    def call():
        blend_accumulate_rows(acc_k, w_k, probs, window, st)

    calls = 3
    spans, tries = _device_spans(call, "blend_rows_kernel", launches, calls,
                                 f"row blend {label}")
    kernel = [ms for name, ms in spans if "blend_rows_kernel" in name]
    copy = [ms for name, ms in spans if "Memcpy" in name]
    plan = [ms for name, ms in spans
            if "blend_rows_kernel" not in name and "Memcpy" not in name]
    ms, copy_ms, plan_ms = (sum(x) / calls for x in (kernel, copy, plan))
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    call_ms = statistics.median(walls)
    s = np.sort(starts.astype(np.int64))
    covered = int(np.minimum(np.diff(s), r).sum()) + r  # rows in the union
    nbytes = (2 * covered * (c + 1) * 4 + probs.nbytes + window.nbytes
              + starts.nbytes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[11] blend_accumulate_rows {label}: acc {tuple(acc0.shape)}, "
        f"{len(starts)} segments of {r} rows, {launches} launch per call "
        f"(trace: {len(kernel)} in {calls} calls, try {tries}); "
        f"bitwise_equal={equal} "
        f"max_abs_err={err:.3e}; device time per call (profiler): kernel "
        f"{ms:.4f} ms ({', '.join(f'{t:.4f}' for t in kernel)}), plan "
        f"{plan_ms:.4f} ms in {len(plan) / calls:g} "
        f"kernels, starts to the device {copy_ms:.4f} ms; whole call "
        f"{call_ms:.3f} ms (host clock, median of 10); plain loop "
        f"{plain_ms:.1f} ms; byte bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f}"
        f" GB), {bound_ms / ms:.1%} of it; no single PyTorch call")
    check(equal, f"row blend {label}: kernel differs from the plain loop")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                share_of_bound=bound_ms / ms, plan_ms=plan_ms,
                copy_ms=copy_ms, call_ms=call_ms), launches


def phase_rows():
    """Row blend vs its plain loop at the evaluation slice's geometry, at a
    ragged one, with segments longer than 256 rows and 10 channels (two
    passes of the kernel's 8), and with no segments."""
    from vnet_tpu_torch.infer.sliding_window import cosine_window
    from vnet_tpu_torch.ops.blend import blend_accumulate_rows

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
    starts[-1] = big_r - r_small  # flush with R
    _rows_case(big_r, 3, starts.astype(np.int32),
               torch.rand((r_small, 1), generator=gen, device="cuda") + 0.5,
               gen, "ragged geometry")
    big_r, r_long = 20011, 300
    starts = rng.integers(0, big_r - r_long + 1, size=500)
    _rows_case(big_r, 10, starts.astype(np.int32),
               torch.rand((r_long, 1), generator=gen, device="cuda") + 0.5,
               gen, "segments of 300 rows, 10 channels")
    acc = torch.rand((64, 3), generator=gen, device="cuda")
    before = acc.clone()
    reset_counts()
    blend_accumulate_rows(acc, torch.zeros((64, 1), device="cuda"),
                          torch.zeros((0, 8, 3), device="cuda"),
                          torch.ones((8, 1), device="cuda"),
                          torch.zeros(0, dtype=torch.int32))
    none = read_counts()["blend_rows"]
    say(f"[11] no segments: {none} launches, acc unchanged="
        f"{torch.equal(acc, before)}")
    check(none == 0 and torch.equal(acc, before), "no segments launched")
    return result, launches


def phase_cuda_tests():
    """The ``cuda``-marked tests in a subprocess, without ``conftest.py``
    (it imports JAX, which this machine need not have)."""
    import glob
    import re

    files = sorted(glob.glob(os.path.join(ROOT, "tests",
                                          "test_torch_cuda_*.py")))
    check(len(files) >= 5, f"cuda test modules: {files}")
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider", *files]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|error|errors)", "\n".join(tail))}
    passed = counts.get("passed", 0)
    say(f"[12] cuda-marked tests ({len(files)} modules, pytest --noconftest "
        f"-m cuda): exit {proc.returncode}, {counts} in {wall:.1f} s")
    if proc.returncode != 0 or passed == 0:
        for line in tail:
            say(f"[12]   {line}")
    check(proc.returncode == 0,
          "a cuda-marked test failed:\n" + "\n".join(tail))
    check(passed > 0, "no cuda-marked test passed")
    return passed


def _attention_config(tmp, **setting):
    """``config_attention_multimodal.json`` with its directories under
    ``tmp``, the shipped liver pipeline and ``setting`` applied."""
    with open(ATTENTION_CONFIG) as f:
        cfg = json.load(f)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    pipeline = os.path.join(ROOT, "pipeline", "pipeline_liver3D.yaml")
    ts["Data"]["TrainingDataDirectory"] = os.path.join(tmp, "training")
    ts["Data"]["TestingDataDirectory"] = os.path.join(tmp, "training")
    ts.update(LogDir=os.path.join(tmp, "log"),
              CheckpointDir=os.path.join(tmp, "ckpt"), Pipeline=pipeline,
              Restore=False, **setting)
    es.update(CheckpointPath=ts["CheckpointDir"], Pipeline=pipeline)
    es["Data"]["EvaluateDataDirectory"] = os.path.join(tmp, "evaluate")
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, cfg


def phase_attention_step():
    """The attention-gated training step at the shipped config's width,
    through ``Trainer.train_step`` (host arrays in, as the loop feeds it)."""
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.train import Trainer

    tmp = tempfile.mkdtemp(prefix="vnet_smoke_att_")
    try:
        path, cfg = _attention_config(tmp)
        trainer = Trainer(load_config(path), device="cuda", log=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    net = trainer.network
    ts = cfg["TrainingSetting"]
    check(type(net).__name__ == "AttentionGatedVNet", type(net).__name__)
    check(ts["BatchSize"] == ATT_BATCH and tuple(ts["PatchShape"])
          == TRAIN_PATCH, "the attention config's batch or patch changed")
    n_drop, n_vnet = len(net.dropouts), len(net.vnet.dropouts)
    check(n_vnet == 21 and n_drop - n_vnet == 12,
          f"module tree: {n_vnet} backbone and {n_drop - n_vnet} head "
          f"dropout layers")
    rng = np.random.default_rng(SEED)
    shape = (ATT_BATCH,) + TRAIN_PATCH
    images = rng.normal(0.0, 1.0, size=shape + (2,)).astype(np.float32)
    labels = (rng.random(shape) > 0.7).astype(np.int32)
    dmaps = rng.random(shape).astype(np.float32)
    state = trainer.init_state()
    times, losses, att_losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(ATT_WARMUP + ATT_STEPS):
        if i == ATT_WARMUP:
            reset_counts()
        t0 = time.perf_counter()
        out = trainer.train_step(state, images, labels, 1000 + i, dmaps)
        losses.append(float(out.loss))  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
        att_losses.append(float(out.aux["attention_loss"]))
    counts = held_bn(read_counts(), "13")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[ATT_WARMUP:])
    per_step = counts["dropout"] / ATT_STEPS
    say(f"[13] attention step (config_attention_multimodal.json: 16 ch, 4 "
        f"levels, heads of {ATT_CHANNELS} ch, 2 modalities, batch "
        f"{ATT_BATCH}, 64^3, bf16, DropoutImpl xla): median {ms:.1f} ms per "
        f"step over {ATT_STEPS} after {ATT_WARMUP} warm-ups (host clock to "
        f"the loss on the host; steps {', '.join(f'{t:.1f}' for t in times)}"
        f"), {ATT_BATCH / ms * 1e3:.1f} patches/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; losses {losses}; attention losses "
        f"{att_losses}; dropout launches per step {per_step:g} (expected "
        f"2 x ({n_vnet} + {n_drop - n_vnet})), other launches {counts}")
    check(all(np.isfinite(losses)) and all(np.isfinite(att_losses)),
          "non-finite attention step losses")
    check(per_step == 2 * n_drop, f"dropout launches {per_step} per step, "
                                  f"expected {2 * n_drop}")
    check(counts["dropout"] == sum(counts.values()),
          f"the attention step launched other kernels: {counts}")
    del trainer, state, net
    torch.cuda.empty_cache()
    return counts["dropout"], ms, peak


# ----------------------------------------------------------------------
# phase 20: data parallelism, two gloo ranks on the one card
# ----------------------------------------------------------------------
def _dp_evaluate(mesh, cfg_path, case_dir, device):
    """(d): one case of the evaluation config through ``Evaluator`` (the
    grid sharded over ``mesh``), every blend launch held bitwise against
    the plain slice-adds."""
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.infer import sliding_window
    from vnet_tpu_torch.infer.evaluator import Evaluator

    checked = []
    kernel = sliding_window.blend_accumulate_patches
    sliding_window.blend_accumulate_patches = _held_blend(checked)
    try:
        ev = Evaluator(load_config(cfg_path), device=device, mesh=mesh)
        reset_counts()
        label, probs = ev.evaluate_case(case_dir)
        torch.cuda.synchronize()
        counts = held_bn(read_counts(), "20d")
    finally:
        sliding_window.blend_accumulate_patches = kernel
    return dict(label=np.asarray(label.data),
                probs=np.stack([np.asarray(p.data) for p in probs]),
                checked=checked, counts=counts)


def _dp_rank(tmp, cfg_path, case_dir):
    """Phase 20 on one of two ``gloo`` ranks sharing card 0."""
    from vnet_tpu_torch.parallel import make_mesh
    from vnet_tpu_torch.tools.dp_bench import rank_results

    mesh = make_mesh(device="cuda:0")
    out = rank_results(mesh)
    out["evaluate"] = _dp_evaluate(mesh, cfg_path, case_dir, "cuda:0")
    torch.save(out, os.path.join(tmp, f"dp_rank{mesh.rank}.pt"))


def phase_data_parallel(tmp):
    """Phase 20: two ``gloo`` ranks on the one card against one process:
    (a) the float32 flagship step, (b) the bf16 flagship step at batch 96,
    (d) the sharded evaluation; (c) is phase 7."""
    from vnet_tpu_torch.io import MedicalImage, write_image
    from vnet_tpu_torch.models import build_network
    from vnet_tpu_torch.parallel import launch
    from vnet_tpu_torch.tools import dp_bench
    from vnet_tpu_torch.train import checkpoints

    cfg_path, cfg = _write_config(tmp)
    ts = cfg["TrainingSetting"]
    case_dir = os.path.join(tmp, "evaluate", "case_0")
    os.makedirs(case_dir)
    write_image(MedicalImage(_synthetic_image(np.random.default_rng(SEED)),
                             (0.75, 0.75, 0.75)),
                os.path.join(case_dir, "image.nii"))
    net_cfg = ts["Networks"]
    net = build_network(
        "VNet", num_classes=len(ts["SegmentationClasses"]),
        num_channels=net_cfg["NumChannel"], num_levels=net_cfg["NumLevels"],
        num_convolutions=net_cfg["NumConvolutions"],
        bottom_convolutions=net_cfg["BottomConvolutions"],
        norm=net_cfg["Norm"], device="cpu",
        generator=torch.Generator().manual_seed(SEED))
    checkpoints.save(ts["CheckpointDir"], net.state_dict(), 0)

    t0 = time.perf_counter()
    ref_a = dp_bench.train_check()
    torch.cuda.empty_cache()
    exact_a = dp_bench.exact_check()
    ref_d = _dp_evaluate(None, cfg_path, case_dir, "cuda")
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch(_dp_rank, DP_RANKS, backend="gloo", device="cuda:0",
           init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
           args=(tmp, cfg_path, case_dir), timeout=DP_TIMEOUT)
    ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"),
                        weights_only=False) for r in range(DP_RANKS)]
    say(f"[20] one process {ref_s:.1f} s (the float64 step on the host's "
        f"CPU included); {DP_RANKS} gloo ranks on card 0 "
        f"{time.perf_counter() - t0:.1f} s (spawn, import, build included)")
    check([(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)],
          "ranks did not form a group of two")

    # (a) float32, TF32 off: the ranks' step is the single process's;
    # (b) bf16 at batch 96: a functional reading, both ranks on one card
    failed = (dp_bench.report_train(ref_a, exact_a, ranks, "[20a]")
              + dp_bench.report_timing(ranks, "[20b]"))
    check(not failed, "; ".join(failed))

    # (d) the sharded evaluation against one process
    prob_err = max(float(np.abs(r["evaluate"]["probs"] - ref_d["probs"])
                         .max()) for r in ranks)
    top2 = np.sort(ref_d["probs"], axis=0)
    decided = (top2[-1] - top2[-2]) > DP_LABEL_GAP
    label_diff = max(int(((r["evaluate"]["label"] != ref_d["label"])
                          & decided).sum()) for r in ranks)
    held = [r["evaluate"]["checked"] for r in ranks]
    blends = [r["evaluate"]["counts"]["blend_accumulate"] for r in ranks]
    say(f"[20d] sharded evaluation of one {SLICE_VOLUME} case at "
        f"config_eval_gaussian.json over {DP_RANKS} ranks vs one process: "
        f"max prob diff {prob_err:.2e} (tolerance {DP_PROB_ATOL:g}), labels "
        f"differ at {label_diff} of {int(decided.sum())} voxels whose top two "
        f"probabilities differ by more than {DP_LABEL_GAP:g}; blend launches "
        f"per rank {blends} (one process "
        f"{ref_d['counts']['blend_accumulate']}), each bitwise "
        f"the plain slice-adds {[[c[0] for c in h] for h in held]}")
    check(prob_err <= DP_PROB_ATOL, f"sharded probabilities off {prob_err}")
    check(label_diff == 0, f"sharded labels differ at {label_diff} voxels")
    check(all(n >= 1 and len(h) == n and all(c[0] for c in h)
              for n, h in zip(blends, held)),
          "a rank did not launch the blend kernel or a launch differs")
    return ranks


# ----------------------------------------------------------------------
# phase 23: spatial partitioning, two gloo ranks on the one card
# ----------------------------------------------------------------------
def _eval_network():
    """``config_eval_gaussian.json``'s network (packed, as the evaluator
    builds it), weights from ``SEED``, float32 on the card."""
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.models import build_network

    t = load_config(EVAL_CONFIG).train
    n = t.network
    return build_network(
        "VNet", num_classes=t.num_classes, num_channels=n.num_channel,
        num_levels=n.num_levels, num_convolutions=n.num_convolutions,
        bottom_convolutions=n.bottom_convolutions, norm=n.norm,
        dropout_rate=n.dropout, device="cuda",
        generator=torch.Generator().manual_seed(SEED))


def _sp_volume():
    return np.random.default_rng(SEED).normal(
        size=SLICE_VOLUME + (1,)).astype(np.float32)


def _sp_rank(tmp):
    """Phase 23 on one of two ``gloo`` ranks sharing card 0."""
    from vnet_tpu_torch.parallel import make_mesh
    from vnet_tpu_torch.parallel.spatial import spatial_sharded_forward
    from vnet_tpu_torch.tools import sp_bench

    mesh = make_mesh(data_parallel=1, space_parallel=SP_RANKS,
                     device="cuda:0")
    out = {"rank": mesh.rank, "world": mesh.world_size,
           "grid": (mesh.data_index, mesh.space_index)}
    reset_counts()  # read after (c): every launch of the ranks' run
    with _holding() as (blends, drops):
        a = sp_bench.train_check(mesh, mesh.device)
        torch.cuda.synchronize()
        counts = held_bn(read_counts(), "23a")
    flat = torch.cat([v.float().reshape(-1) for v in a["state"].values()]
                     ).to(mesh.device)
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    a["ranks_equal"] = bool(torch.equal(ref, flat))
    if mesh.rank:
        del a["grads"], a["state"]
    out["train"] = a
    out["held"] = (blends, drops, counts)
    torch.cuda.empty_cache()
    held_b = []
    out["timing"] = [sp_bench.step_timing(mesh, mesh.device, SP_BATCH,
                                          hold=_held_step(held_b))]
    out["held_b"] = held_b[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        logits = spatial_sharded_forward(_eval_network(), _sp_volume(), mesh)
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    if mesh.rank == 0:
        out["logits"] = logits.cpu().numpy()
    out["counts"] = held_bn(read_counts(), "23")
    torch.save(out, os.path.join(tmp, f"sp_rank{mesh.rank}.pt"))


def phase_spatial(tmp):
    """Phase 23: two ``gloo`` ranks on the one card at ``SpaceParallel`` 2
    against one process: (a) the float32 flagship step, (b) the bf16 step,
    (c) the halo-sharded forward of one whole volume. Returns the ranks'
    dropout launches in (a) and (b)."""
    from vnet_tpu_torch.models import eval_apply
    from vnet_tpu_torch.parallel import launch
    from vnet_tpu_torch.tools import dropout_bench, sp_bench

    t0 = time.perf_counter()
    ref_a = sp_bench.train_check()
    exact_a = sp_bench.exact_check()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref_c = eval_apply(_eval_network(), torch.from_numpy(
            _sp_volume()).cuda()[None])[0].cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch(_sp_rank, SP_RANKS, backend="gloo", device="cuda:0",
           init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
           args=(tmp,), timeout=SP_TIMEOUT)
    ranks = [torch.load(os.path.join(tmp, f"sp_rank{r}.pt"),
                        weights_only=False) for r in range(SP_RANKS)]
    say(f"[23] one process {ref_s:.1f} s; {SP_RANKS} gloo ranks on card 0 "
        f"{time.perf_counter() - t0:.1f} s (spawn, import, build included)")
    check([r["grid"] for r in ranks] == [(0, s) for s in range(SP_RANKS)],
          "ranks did not form one data row of two space ranks")

    # (a) the ranks' float32 step is the single process's, masks joined
    failed = sp_bench.report_train(ref_a, exact_a, ranks, "[23a]")
    check(not failed, "; ".join(failed))
    for r in ranks:
        blends, drops, counts = r["held"]
        maps = sorted({c[5] for c in drops})
        say(f"[23a] rank {r['rank']} row maps (L, G) of its dropout "
            f"launches: {maps}")
        check(all(0 < g == SP_RANKS * l for l, g in maps),
              f"rank {r['rank']} launched dropout without a slab's row map")
        _check_held(f"23a rank {r['rank']}", blends, drops, counts)
    # (b) a functional reading, both ranks on one card, its first step held
    failed = sp_bench.report_timing(ranks, "[23b]")
    check(not failed, "; ".join(failed))
    steps_b = sp_bench.STEPS + 2  # held, warm-up, timed; (c) launches none
    # the flagship's dropout inputs at SP_BATCH, each rank's slab of them
    # under its row map (L, G)
    slabs = {(slab, tuple(row_map[1:])) for slab, row_map in (
        dropout_bench.slab_map(s, SP_RANKS)
        for s, _ in dropout_bench.dropout_shapes("flagship",
                                                 batch=SP_BATCH))}
    for r in ranks:
        t = r["timing"][0]
        check(t["per_step"]["dropout"] == 2 * 21,
              f"[23b] dropout launches a step {t['per_step']}")
        blends, drops, counts = r["held_b"]
        check({(c[2], c[5]) for c in drops} == slabs,
              f"[23b] rank {r['rank']} held shapes and row maps "
              f"{sorted({(c[2], c[5]) for c in drops})}, not {slabs}")
        _check_held(f"23b rank {r['rank']}", blends, drops, counts)
        check(r["counts"]["dropout"] == 2 * 21 * (1 + steps_b),
              f"[23] rank {r['rank']} launched dropout "
              f"{r['counts']['dropout']} times in (a), (b) and (c), not "
              f"{2 * 21 * (1 + steps_b)}")
    # (c) the halo-sharded forward of one whole volume against one process
    err = float(np.abs(ranks[0]["logits"] - ref_c).max())
    scale = float(np.abs(ref_c).max())
    say(f"[23c] spatial_sharded_forward of one {SLICE_VOLUME} volume at "
        f"config_eval_gaussian.json's network, f32 TF32 off, {SP_RANKS} "
        f"slabs of the first axis vs the unsharded forward: max |diff| "
        f"{err:.3e} of max |logit| {scale:.3e} (tolerance "
        f"{SP_FORWARD_RTOL:g} relative); forward "
        f"{[round(r['forward_s'], 2) for r in ranks]} s a rank")
    check(ranks[0]["logits"].shape == ref_c.shape
          and np.isfinite(ranks[0]["logits"]).all(),
          f"sharded logits {ranks[0]['logits'].shape} vs {ref_c.shape}")
    check(err <= SP_FORWARD_RTOL * scale,
          f"sharded forward off by {err} (max |logit| {scale})")
    return sum(r["counts"]["dropout"] for r in ranks)


def _two_modality_case(rng):
    img, label = _train_case(rng)
    t2 = (200.0 - img + rng.normal(0.0, 5.0, size=img.shape)).astype(
        np.float32)
    return img, t2, label


def _blend_width(vz: int, pz: int, sz, c: int) -> int:
    """Floats per element of the blend kernel's path at a geometry: 4 (the
    float4 path) where VZ·C, PZ·C and every sz·C are multiples of 4, else 1
    (csrc/blend_accumulate.cu)."""
    return 4 if all(n * c % 4 == 0 for n in [vz, pz] + list(sz)) else 1


def _held_blend(checked):
    """A stand-in for the sliding window's blend: the kernel on the batch,
    then the plain slice-adds on a copy of the accumulator from before it;
    appends ``(bitwise equal, max abs err, width taken, width expected,
    contrib shape)`` to ``checked`` per call."""
    from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                          blend_accumulate_plain)

    def blend(acc, contrib, starts):
        before = acc.clone()
        blend_accumulate_patches(acc, contrib, starts)
        width = blend_accumulate_patches.last_width
        ref = blend_accumulate_plain(before, contrib, starts)
        checked.append((torch.equal(acc, ref),
                        (acc - ref).abs().max().item(), width,
                        _blend_width(acc.shape[2], contrib.shape[3],
                                     starts[:, 2].tolist(), acc.shape[-1]),
                        tuple(contrib.shape)))
        return acc

    return blend


def phase_attention_cli(tmp):
    """The attention config's CLI path with ImageLog, DeviceAugment,
    Testing and a trace, then evaluation of its checkpoint, its every
    blend held bitwise against the plain slice-adds."""
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.infer import sliding_window
    from vnet_tpu_torch.io import MedicalImage, read_image, write_image
    from vnet_tpu_torch.train.events import (PNG_SIGNATURE, event_files,
                                             read_events)

    steps = 4
    path, cfg = _attention_config(
        tmp, BatchSize=4, MaxIterations=steps, LogInterval=2, TestStep=2,
        ImageLog=True, DeviceAugment=True, Testing=True)
    ts = cfg["TrainingSetting"]
    names = ts["Data"]["ImageFilenames"]
    rng = np.random.default_rng(SEED)
    for split, n in (("training", 4), ("evaluate", 2)):
        for i in range(n):
            img, t2, label = _two_modality_case(rng)
            case_dir = os.path.join(tmp, split, f"case_{i}")
            os.makedirs(case_dir)
            for name, vol in zip(names, (img, t2)):
                write_image(MedicalImage(vol, (0.75,) * 3),
                            os.path.join(case_dir, name))
            if split == "training":
                write_image(MedicalImage(label.clip(0, 1), (0.75,) * 3),
                            os.path.join(case_dir, "label.nii"))
    trace_dir = os.path.join(tmp, "trace")
    reset_counts()
    t0 = time.perf_counter()
    state = main(["-p", "train", "--config_json", path, "--device", "cuda",
                  "--profile_dir", trace_dir])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = held_bn(read_counts(), "14")
    check(state.step == steps, f"trained {state.step} steps")
    traces = [n for n in os.listdir(trace_dir) if n.endswith(".json")]
    check(len(traces) == 1, f"trace files {traces}")
    trace_mb = os.path.getsize(os.path.join(trace_dir, traces[0])) / 1e6
    summary = {}
    for tag in ("train", "test"):
        log_dir = os.path.join(ts["LogDir"], tag)
        files = event_files(log_dir)
        check(len(files) == 1, f"{tag}: event files {files}")
        values = [v for e in read_events(files[0]) for v in e["values"]]
        scalars = {v["tag"] for v in values if "simple_value" in v}
        images = [v["image"]["encoded"] for v in values if "image" in v]
        with open(os.path.join(log_dir, "scalars.jsonl")) as f:
            jsonl = {json.loads(line)["tag"] for line in f}
        check(scalars == jsonl, f"{tag}: event tags {sorted(scalars)} != "
                                f"scalars.jsonl tags {sorted(jsonl)}")
        check(images and all(im.startswith(PNG_SIGNATURE) for im in images),
              f"{tag}: no PNG image records")
        summary[tag] = (len(scalars), len(images))
        if tag == "train":
            check("loss/attention_loss" in scalars,
                  "no attention loss logged")
    with open(os.path.join(ts["CheckpointDir"], "network_config.json")) as f:
        sidecar = json.load(f)
    keys = {"Name", "Dropout", "NumChannel", "NumLevels", "NumConvolutions",
            "BottomConvolutions", "Attention", "Norm", "PackedTargetLanes",
            "DropoutImpl", "Remat", "DwImpl"}
    check(set(sidecar["Networks"]) == keys
          and sidecar["Networks"]["Attention"] is True
          and {"SegmentationClasses", "PatchShape", "Precision"} <= set(
              sidecar), f"network_config.json {sidecar}")

    checked = []
    kernel = sliding_window.blend_accumulate_patches
    sliding_window.blend_accumulate_patches = _held_blend(checked)
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = main(["-p", "evaluate", "--config_json", path, "--device",
                        "cuda"])
        torch.cuda.synchronize()
    finally:
        sliding_window.blend_accumulate_patches = kernel
    eval_s = time.perf_counter() - t0
    eval_counts = held_bn(read_counts(), "14")
    labels = [set(np.unique(read_image(r).data).tolist()) for r in results]
    say(f"[14] attention CLI: {steps} training steps at batch "
        f"{ts['BatchSize']} with "
        f"ImageLog, DeviceAugment, Testing and --profile_dir in "
        f"{train_s:.1f} s (incl. data loading, image logs, checkpoints, "
        f"tracing), launches {train_counts}; event files (scalar tags, "
        f"images) {summary}, CRCs hold, tags equal scalars.jsonl; trace "
        f"{traces[0]} {trace_mb:.1f} MB; network_config.json keys "
        f"{sorted(sidecar['Networks'])}; evaluation of {len(results)} "
        f"cases in {eval_s:.1f} s (incl. the plain blend beside each "
        f"kernel call), launches {eval_counts}, label values {labels}")
    say(f"[14] evaluation blends vs the plain slice-adds on the same "
        f"batches: {len(checked)} calls, contrib shapes "
        f"{sorted({c[4] for c in checked})}, bitwise equal "
        f"{sum(c[0] for c in checked)}/{len(checked)}, max abs err "
        f"{max((c[1] for c in checked), default=float('nan')):.3e}, widths "
        f"taken {sorted({c[2] for c in checked})} (expected "
        f"{sorted({c[3] for c in checked})})")
    check(train_counts["dropout"] == 2 * len(state.network.dropouts) * steps,
          f"training dropout launches {train_counts['dropout']}")
    check(len(results) == 2 and all(v <= {0, 1} for v in labels),
          f"evaluation labels {labels}")
    check(eval_counts["blend_accumulate"] > 0
          and eval_counts["blend_accumulate"] == sum(eval_counts.values()),
          f"evaluation launches {eval_counts}")
    check(len(checked) == eval_counts["blend_accumulate"],
          f"{len(checked)} blends held for {eval_counts} launches")
    check(all(c[0] for c in checked),
          "an evaluation blend differs from the plain slice-adds")
    check(all(c[2] == c[3] for c in checked),
          "an evaluation blend took another float path than its geometry "
          "implies")
    return train_counts["dropout"]


def _case_2d(rng):
    """A 320x320x48 volume at 0.75 mm: noise around 100 (sigma 20) and a
    bright sphere labelled 1 (radius 20 voxels), so most slices hold more
    than ``MinPixel`` labelled pixels and a 256^2 crop holds image."""
    img = rng.normal(100.0, 20.0, size=CASE_2D).astype(np.float32)
    label = np.zeros(CASE_2D, np.uint8)
    x, y, z = np.ogrid[tuple(slice(0, s) for s in CASE_2D)]
    cx, cy = (int(rng.integers(100, s - 100)) for s in CASE_2D[:2])
    cz = int(rng.integers(20, CASE_2D[2] - 20))
    ball = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= 400
    img[ball] += 40.0
    label[ball] = 1
    return img, label


def _config_2d(tmp):
    """``config_2d.json`` with its directories under ``tmp``, the shipped
    2D pipeline, 4 steps and a test batch every 2."""
    with open(CONFIG_2D) as f:
        cfg = json.load(f)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    pipeline = os.path.join(ROOT, "pipeline", "pipeline2D.yaml")
    ts["Data"]["TrainingDataDirectory"] = os.path.join(tmp, "training")
    ts["Data"]["TestingDataDirectory"] = os.path.join(tmp, "training")
    ts.update(LogDir=os.path.join(tmp, "log"),
              CheckpointDir=os.path.join(tmp, "ckpt"), Pipeline=pipeline,
              Restore=False, MaxIterations=4, LogInterval=2, TestStep=2,
              CacheCases=6)
    es.update(CheckpointPath=ts["CheckpointDir"], Pipeline=pipeline)
    es["Data"]["EvaluateDataDirectory"] = os.path.join(tmp, "evaluate")
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, cfg


def phase_2d_cli(tmp):
    """``config_2d.json`` through the CLI: 4 training steps at full width
    and batch 32, then slice-stacked evaluation of 2 cases, its every blend
    held bitwise against the plain slice-adds."""
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.infer import sliding_window
    from vnet_tpu_torch.io import MedicalImage, read_image, write_image
    from vnet_tpu_torch.train import Trainer, checkpoints

    path, cfg = _config_2d(tmp)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    check(ts["BatchSize"] == BATCH_2D and tuple(ts["PatchShape"]) == PATCH_2D
          and tuple(es["Stride"]) == EVAL_STRIDE_2D
          and es["BatchSize"] == SLICE_BATCH,
          "config_2d.json's batch, patch or stride changed")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for i in range(6):
        img, label = _case_2d(rng)
        case_dir = os.path.join(tmp, "training", f"case_{i}")
        os.makedirs(case_dir)
        write_image(MedicalImage(img, (0.75,) * 3),
                    os.path.join(case_dir, "image.nii"))
        write_image(MedicalImage(label, (0.75,) * 3),
                    os.path.join(case_dir, "label.nii"))
    sources = []
    for i in range(2):
        case_dir = os.path.join(tmp, "evaluate", f"case_{i}")
        os.makedirs(case_dir)
        write_image(MedicalImage(_synthetic_image(rng), (0.75,) * 3),
                    os.path.join(case_dir, "image.nii"))
        sources.append(case_dir)
    data_s = time.perf_counter() - t0

    steps = ts["MaxIterations"]
    reset_counts()
    t0 = time.perf_counter()
    state = main(["-p", "train", "--config_json", path, "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = held_bn(read_counts(), "15")
    n_dropout = len(state.network.dropouts)
    with open(os.path.join(ts["LogDir"], "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    with open(os.path.join(ts["LogDir"], "test", "scalars.jsonl")) as f:
        test_losses = [json.loads(line)["value"] for line in f
                       if '"loss/0.total_loss"' in line]
    say(f"[15] 2D train (config_2d.json: 16 ch, 4 levels, bf16, xla "
        f"dropout): {steps} steps at batch {ts['BatchSize']}, patch "
        f"{PATCH_2D}, in {train_s:.2f} s (incl. the slice inventory, data "
        f"loading, model build, first-call warm-up, 384^2 test batches, "
        f"checkpoints; {data_s:.1f} s before it writing the cases); losses "
        f"{losses}; test losses {test_losses}; launches {counts}; "
        f"{n_dropout} dropout layers")
    check(state.step == steps, f"trained {state.step} steps, not {steps}")
    check(state.network.spatial_rank == 2, "the network is not 2D")
    # MaxIterations stops the loop inside an epoch before the last step's
    # scalars are written (they are logged one step late), as in the JAX
    # trainer; phase 7's epochs end with its last step
    check(len(losses) == steps - 1 and all(np.isfinite(losses)),
          f"losses {losses}")
    check(len(test_losses) == 2 and all(np.isfinite(test_losses)),
          f"test losses {test_losses}")
    check(n_dropout == 21, f"{n_dropout} dropout layers")
    check(counts["dropout"] == 2 * n_dropout * steps,
          f"dropout launches {counts['dropout']} != {2 * n_dropout * steps}")
    check(counts["dropout"] == sum(counts.values()),
          f"2D training launched other kernels: {counts}")
    saved = checkpoints.restore_latest_state(ts["CheckpointDir"])
    check(saved is not None and saved["step"] == steps,
          "no checkpoint of the last step")
    fresh = Trainer(load_config(path), device="cuda", log=False)
    fresh.network.load_state_dict(saved["model"])
    fresh.optimizer.load_state_dict(saved["optimizer"])
    trained = state.network.state_dict()
    same = all(torch.equal(v, trained[k])
               for k, v in fresh.network.state_dict().items())
    check(same, "restored 2D weights differ from the trained ones")
    del state, fresh, trained, saved
    torch.cuda.empty_cache()

    checked = []
    kernel = sliding_window.blend_accumulate_patches
    sliding_window.blend_accumulate_patches = _held_blend(checked)
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = main(["-p", "evaluate", "--config_json", path, "--device",
                        "cuda"])
        torch.cuda.synchronize()
    finally:
        sliding_window.blend_accumulate_patches = kernel
    eval_s = time.perf_counter() - t0
    eval_counts = held_bn(read_counts(), "15")
    grid = sliding_window.build_patch_grid(SLICE_VOLUME[:2], PATCH_2D,
                                           EVAL_STRIDE_2D)
    per_case = -(-SLICE_VOLUME[2] * len(grid) // SLICE_BATCH)
    summary = []
    for case_dir, result in zip(sources, results):
        label = read_image(result)
        src = read_image(os.path.join(case_dir, "image.nii"))
        values = set(np.unique(label.data).tolist())
        check(label.GetSize() == src.GetSize(), f"label {label.GetSize()}")
        check(values <= {0, 1}, f"label values {values}")
        for c in ts["SegmentationClasses"]:
            prob = read_image(os.path.join(case_dir,
                                           f"probability_tf_{c}.nii.gz"))
            check(prob.GetSize() == src.GetSize(), f"prob {prob.GetSize()}")
            check(bool(np.isfinite(prob.data).all()), "non-finite prob map")
        summary.append((sorted(values), int(np.count_nonzero(label.data))))
    say(f"[15] 2D evaluation of {len(results)} {SLICE_VOLUME} cases "
        f"(stride {EVAL_STRIDE_2D}, batch {SLICE_BATCH}, {len(grid)} patches "
        f"a slice, slice-stacked) in {eval_s:.1f} s (incl. model build, "
        f"checkpoint load, host slice transforms, the plain blend beside "
        f"each kernel call, resampling, LCC and .nii.gz writes of a label "
        f"and 2 probability maps a case); launches {eval_counts} "
        f"({per_case} a case expected); (label values, foreground voxels) "
        f"{summary}")
    say(f"[15] 2D evaluation blends vs the plain slice-adds on the same "
        f"batches: {len(checked)} calls, contrib shapes "
        f"{sorted({c[4] for c in checked})}, bitwise equal "
        f"{sum(c[0] for c in checked)}/{len(checked)}, max abs err "
        f"{max((c[1] for c in checked), default=float('nan')):.3e}, widths "
        f"taken {sorted({c[2] for c in checked})} (expected "
        f"{sorted({c[3] for c in checked})})")
    check(len(results) == 2, f"{len(results)} labels written, expected 2")
    check(eval_counts["blend_accumulate"] == 2 * per_case
          and eval_counts["blend_accumulate"] == sum(eval_counts.values()),
          f"2D evaluation launches {eval_counts}, expected {2 * per_case} "
          f"blends")
    check(len(checked) == eval_counts["blend_accumulate"],
          f"{len(checked)} blends held for {eval_counts} launches")
    check(all(c[0] for c in checked),
          "a 2D evaluation blend differs from the plain slice-adds")
    check(all(c[2] == c[3] for c in checked),
          "a 2D evaluation blend took another path than its geometry "
          "implies")
    return counts["dropout"], eval_counts["blend_accumulate"], train_s, eval_s


def _step_2d():
    """``config_2d.json``'s step at batch 32: median ms over 6 steps after
    2 warm-ups, peak memory, launches a step, and the memory format of
    every dropout input in one more step."""
    from vnet_tpu_torch.models.layers import Dropout
    from vnet_tpu_torch.tools.profile_step import config2d_step, timed_steps

    state, step, images, labels = config2d_step("xla", BATCH_2D, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    timed_steps(state, step, images, labels, ATT_WARMUP)
    reset_counts()
    times, losses = timed_steps(state, step, images, labels, ATT_STEPS)
    counts = held_bn(read_counts(), "16")
    peak = torch.cuda.max_memory_allocated()
    formats = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: formats.append(
        args[0].is_contiguous(memory_format=torch.channels_last)))
        for m in state.network.modules() if isinstance(m, Dropout)]
    timed_steps(state, step, images, labels, 1)
    for h in hooks:
        h.remove()
    ms = statistics.median(times)
    say(f"[16] config_2d.json step (16 ch, 4 levels, 2 classes, Sørensen, "
        f"Adam, DropoutImpl xla) batch {BATCH_2D} {PATCH_2D} bf16: median "
        f"{ms:.2f} ms per step over {ATT_STEPS} after {ATT_WARMUP} warm-ups "
        f"(host clock to the loss on the host; steps "
        f"{', '.join(f'{t:.2f}' for t in times)}), "
        f"{BATCH_2D / ms * 1e3:.1f} patches/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; losses {losses}; launches a step "
        f"{ {k: v / ATT_STEPS for k, v in counts.items() if v} }; dropout "
        f"inputs channels-last {sum(formats)}/{len(formats)}")
    check(all(np.isfinite(losses)), f"2D step losses {losses}")
    check(counts["dropout"] == 42 * ATT_STEPS
          and counts["dropout"] == sum(counts.values()),
          f"2D step launches {counts}")
    check(len(formats) == 21 and all(formats),
          "a dropout input of the 2D network is not channels-last")
    del state, step, images, labels
    torch.cuda.empty_cache()
    return ms, peak


def _dropout_2d(gen):
    """The dropout kernel at the 2D network's dropout shapes: the largest
    held in full, the others bitwise (phase 17 times all five)."""
    from vnet_tpu_torch.ops.dropout import (dropout, dropout_apply,
                                            dropout_params, dropout_plain)
    from vnet_tpu_torch.tools.dropout_bench import dropout_shapes

    rate, seed, stream = 0.01, 20261017, 3
    params = dropout_params(rate, "xla")
    x = (torch.randn(DROP_2D, generator=gen, device="cuda")
         * 30.0).to(torch.bfloat16).contiguous(
             memory_format=torch.channels_last)
    out_k = dropout_apply(x, seed, stream, *params)
    out_p = dropout_plain(x, seed, stream, *params)
    torch.cuda.synchronize()
    equal = torch.equal(out_k, out_p)
    err = (out_k.float() - out_p.float()).abs().max().item()
    layout = out_k.is_contiguous(memory_format=torch.channels_last)
    keep_d = torch.tensor(params[1], dtype=x.dtype).float().cuda()
    kept = out_k != 0
    quotient = torch.equal(out_k[kept], (x.float() / keep_d).to(x.dtype)[kept])
    share = kept.float().mean().item()
    del out_p, kept
    xr = x.detach().requires_grad_()
    y = dropout(xr, seed, stream, rate, "xla")
    g = torch.ones(y.shape, dtype=y.dtype, device="cuda")  # not CL
    (dx,) = torch.autograd.grad(y, xr, g)
    # torch.randn yields an exact 0 about once in 2^24 draws (a uniform of
    # 1.0 in Box-Muller); a kept 0 stays 0 in y, as in phase 5
    zeros = int((x == 0).sum())
    same_mask = (bool((((dx != 0) == (y != 0)) | (x == 0)).all())
                 and torch.equal(y, out_k))
    del xr, y, g, dx, out_k
    plain_ms = time_ms(lambda: dropout_plain(x, seed, stream, *params),
                       reps=3)
    say(f"[16] dropout xla {tuple(x.shape)} bf16 channels-last: "
        f"bitwise_equal={equal} survivors x / keep_d rounded once="
        f"{quotient}, kept {share:.6f}, output channels-last={layout}, "
        f"backward_mask_equal={same_mask} ({zeros} zeros in x); plain "
        f"{plain_ms:.4f} ms")
    check(equal, "2D dropout: kernel differs from the plain version")
    check(quotient, "2D dropout: survivors != x / keep_d")
    check(layout, "2D dropout: output not channels-last")
    check(same_mask, "2D dropout: backward mask != forward mask")
    del x
    torch.cuda.empty_cache()
    shapes = [s for s, _ in dropout_shapes("2d")]
    check(len(shapes) == 5 and shapes[0] == DROP_2D,
          f"2D dropout shapes {shapes}")
    for shape in shapes[1:]:
        err = max(err, _dropout_equal(shape, ("xla",), gen, seed, stream,
                                      "[16]"))
    return dict(max_abs_err=err, plain_ms=plain_ms)


def phase_2d_shapes():
    """The 2D step, then the dropout kernel at the 2D shapes (phase 2 holds
    the blend at the 2D evaluation's geometry)."""
    step_ms, peak = _step_2d()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    drop = _dropout_2d(gen)
    return step_ms, peak, drop


def _patch_batches(shape, patch, stride, batch) -> int:
    """Patch batches of one case's sliding window (one blend launch each)."""
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid

    n = len(build_patch_grid(shape, patch, stride))
    return -(-n // batch)


def _held_dropout(checked):
    """A stand-in for the launch inside the counted dropout wrapper that the
    layers call (forward and backward): the kernel, then the plain version
    on the same input, key, counter base and row map; appends ``(bitwise
    equal, max abs err, shape, divide, thr, row map)`` per launch."""
    from vnet_tpu_torch.ops.dropout import dropout_plain, launch_with

    def held(fn, x, seed, stream, thr, factor, divide, base=0, row_len=0,
             row_stride=0):
        key = (seed, stream, thr, factor, divide, base, row_len, row_stride)
        out = launch_with(fn, x, *key)
        ref = dropout_plain(x, *key)
        checked.append((torch.equal(out, ref),
                        (out.float() - ref.float()).abs().max().item(),
                        tuple(x.shape), bool(divide), int(thr),
                        (int(row_len), int(row_stride))))
        return out

    return held


@contextlib.contextmanager
def _held_step(held):
    """``_holding`` around a block, which appends ``(blends, drops,
    launches in the block)`` to ``held``."""
    before = read_counts()
    with _holding() as (blends, drops):
        yield
        torch.cuda.synchronize()
    held.append((blends, drops, {k: v - before[k]
                                 for k, v in read_counts().items()}))


@contextlib.contextmanager
def _holding():
    """Every blend of the sliding window (``_held_blend``) and every
    dropout of the layers (``_held_dropout``) held against its plain
    version on the same inputs while the block runs; yields the two lists
    of checks. The counted wrappers still launch, once a call."""
    from vnet_tpu_torch.infer import sliding_window

    # the module, not the function that vnet_tpu_torch.ops exports
    ops_dropout = importlib.import_module("vnet_tpu_torch.ops.dropout")
    blends, drops = [], []
    blend, launch = (sliding_window.blend_accumulate_patches,
                     ops_dropout.launch_with)
    sliding_window.blend_accumulate_patches = _held_blend(blends)
    ops_dropout.launch_with = _held_dropout(drops)
    try:
        yield blends, drops
    finally:
        sliding_window.blend_accumulate_patches = blend
        ops_dropout.launch_with = launch


def _check_held(tag, blends, drops, counts):
    """Each launch of the block held, and each bitwise its plain version's;
    the blends on the float path their geometry implies."""
    say(f"[{tag}] held on the path: {len(blends)} blends, contrib shapes "
        f"{sorted({c[4] for c in blends})}, bitwise "
        f"{sum(c[0] for c in blends)}/{len(blends)}, widths taken "
        f"{sorted({c[2] for c in blends})} (expected "
        f"{sorted({c[3] for c in blends})}); {len(drops)} dropouts, shapes "
        f"{sorted({c[2] for c in drops})}, flavours (divide, thr, row map) "
        f"{sorted({c[3:] for c in drops})}, bitwise "
        f"{sum(c[0] for c in drops)}/{len(drops)}, max abs err "
        f"{max((c[1] for c in blends + drops), default=0.0):.3e}")
    check(len(blends) == counts["blend_accumulate"]
          and len(drops) == counts["dropout"],
          f"{len(blends)} blends and {len(drops)} dropouts held for "
          f"launches {counts}")
    check(all(c[0] for c in blends),
          "a blend on the path differs from the plain slice-adds")
    check(all(c[2] == c[3] for c in blends),
          "a blend on the path took another float path than its geometry "
          "implies")
    check(all(c[0] for c in drops),
          "a dropout on the path differs from its plain version")


def _dice_ok(dice: dict) -> bool:
    return all(len(d) == 3 and all(np.isfinite(d)) and
               all(0.0 <= x <= 1.0 for x in d)
               for mode in dice.values() for d in mode.values())


def phase_quickstart(tmp):
    """The quickstart's main path at full width on the card, then a few
    steps of its 2D mode; ``(dropout launches, blend launches)``."""
    from vnet_tpu_torch import quickstart
    from vnet_tpu_torch.io import read_image
    from vnet_tpu_torch.models import build_network

    wd = os.path.join(tmp, "q3")
    argv = ["--workdir", wd, "--steps", str(QS_STEPS), "--n-train",
            str(QS_TRAIN), "--augment", "--drop-ratio", "0.3",
            "--min-pixel", "32", "--seed", "1337", "--device", "cuda",
            "--idle_window", *map(str, QS_IDLE_WINDOW)]
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (held_blends, held_drops):
        result = quickstart.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = held_bn(read_counts(), "21")
    out = result["quickstart"]
    with open(os.path.join(wd, "config.json")) as f:
        cfg = json.load(f)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    net = ts["Networks"]
    n_dropout = len(build_network(
        "VNet", num_classes=3, dropout_rate=net["Dropout"],
        num_channels=net["NumChannel"], num_levels=net["NumLevels"],
        num_convolutions=net["NumConvolutions"],
        bottom_convolutions=net["BottomConvolutions"],
        packed_target_lanes=net["PackedTargetLanes"], device="cpu").dropouts)
    cases = sorted(os.listdir(os.path.join(wd, "evaluate")))
    batches = len(cases) * _patch_batches(
        (96, 96, 64), ts["PatchShape"], es["Stride"], es["BatchSize"])
    say(f"[21] quickstart, full width: {out['steps']} steps at batch "
        f"{out['batch']}, patch {out['patch']}, bf16, DeviceAugment "
        f"{ts['DeviceAugment']}, in {wall:.2f} s (wall {out['wall']}); "
        f"median step {out['median_step_ms']} ms; idle over steps "
        f"{QS_IDLE_WINDOW[0] + 1}-{sum(QS_IDLE_WINDOW)}: {out['idle']}; "
        f"dice {out['dice']}; launches {counts}; module tree: {n_dropout} "
        f"dropout layers; {batches} patch batches over {len(cases)} cases")
    check(out["steps"] == QS_STEPS and out["device"].startswith("cuda"),
          f"quickstart ran {out['steps']} steps on {out['device']}")
    check(ts["Precision"] == "bfloat16" and ts["BatchSize"] == 8
          and ts["PatchShape"] == list(TRAIN_PATCH) and net["NumChannel"] == 16
          and ts["DeviceAugment"], "not the full-width 3D recipe")
    check(n_dropout == 21, f"{n_dropout} dropout layers")
    check(counts["dropout"] == 2 * n_dropout * QS_STEPS,
          f"dropout launches {counts['dropout']} != "
          f"{2 * n_dropout * QS_STEPS}")
    check(counts["blend_accumulate"] == batches,
          f"blend launches {counts['blend_accumulate']} != {batches}")
    check(sorted(out["dice"]) == ["network"]
          and sorted(out["dice"]["network"]) == cases and _dice_ok(out["dice"]),
          f"dice {out['dice']}")
    check(out["median_step_ms"] is not None and out["median_step_ms"] > 0,
          "no logged step time")
    _check_held("21", held_blends, held_drops, counts)
    drops, blends = counts["dropout"], counts["blend_accumulate"]

    wd2 = os.path.join(tmp, "q2")
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (held_blends, held_drops):
        result = quickstart.main(["--workdir", wd2, "--steps",
                                  str(QS2D_STEPS), "--rank2", "--small",
                                  "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = held_bn(read_counts(), "21")
    out = result["quickstart"]
    with open(os.path.join(wd2, "config.json")) as f:
        es2 = json.load(f)["EvaluationSetting"]
    cases = sorted(os.listdir(os.path.join(wd2, "evaluate")))
    # slice-stacked: every z-slice of a 48x48x32 case is one 48^2 patch
    batches = 2 * len(cases) * -(-32 // es2["BatchSize"])
    preds = {}
    for mode, name in quickstart.RANK2_MODES.items():
        for case in cases:
            path = os.path.join(wd2, "evaluate", case, name)
            check(os.path.exists(path), f"{path} not written")
            preds[mode, case] = np.asarray(read_image(path).data)
    say(f"[21] quickstart --rank2 --small: {out['steps']} steps at batch "
        f"{out['batch']} in {wall:.2f} s; dice {out['dice']}; launches "
        f"{counts}; prediction files "
        f"{sorted(quickstart.RANK2_MODES.values())} in each of {cases}")
    check(out["steps"] == QS2D_STEPS, f"ran {out['steps']} steps")
    check(sorted(out["dice"]) == ["batch_stats", "ema"]
          and _dice_ok(out["dice"]), f"dice {out['dice']}")
    check(all(p.shape == (48, 48, 32) for p in preds.values()),
          "prediction shapes")
    check(counts["blend_accumulate"] == batches,
          f"2D blend launches {counts['blend_accumulate']} != {batches}")
    _check_held("21", held_blends, held_drops, counts)
    return drops, blends + counts["blend_accumulate"]


def phase_flags(tmp):
    """The flag command lines: an attention run, then its evaluation;
    ``(dropout launches, blend launches)``."""
    from vnet_tpu_torch.flags import evaluate as flags_evaluate
    from vnet_tpu_torch.flags import train as flags_train
    from vnet_tpu_torch.io import read_image
    from vnet_tpu_torch.ops.dropout import dropout_params
    from vnet_tpu_torch.utils.synthdata import make_hard_dataset

    steps, patch, batch = 2, 32, 2
    rng = np.random.default_rng(42)
    make_hard_dataset(tmp, "training", 4, rng, shape=(48, 48, 48))
    make_hard_dataset(tmp, "evaluate", 2, rng, shape=(48, 48, 48))
    ckpt = os.path.join(tmp, "ckpt")
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (_, held_drops):
        state = flags_train.main([
            "--attention", "--dropout_impl", "bits8", "--device_augment",
            "--data_dir", tmp, "--batch_size", str(batch), "--patch_size",
            str(patch), "--patch_layer", str(patch), "--max_iterations",
            str(steps), "--optimizer", "adam", "--init_learning_rate",
            "1e-3", "--loss_function", "sorensen", "--drop_ratio", "0.3",
            "--min_pixel", "32", "--cache_cases", "64", "--log_dir",
            os.path.join(tmp, "log"), "--checkpoint_dir", ckpt,
            "--device", "cuda"])
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = held_bn(read_counts(), "22")
    n_dropout = len(state.network.dropouts)
    with open(os.path.join(ckpt, "network_config.json")) as f:
        sidecar = json.load(f)
    _check_held("22", [], held_drops, dict(train_counts, blend_accumulate=0))
    bits8 = dropout_params(sidecar["Networks"]["Dropout"], "bits8")
    check({c[3:5] for c in held_drops} == {(bits8[2], bits8[0])},
          "a dropout on the path is not the bits8 flavour")
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (held_blends, _):
        paths = flags_evaluate.main([
            "--attention", "--data_dir", os.path.join(tmp, "evaluate"),
            "--checkpoint_path", ckpt, "--patch_size", str(patch),
            "--patch_layer", str(patch), "--stride_inplane",
            str(patch // 2), "--stride_layer", str(patch // 2),
            "--batch_size", "4", "--label_filename", "pred.nii.gz",
            "--device", "cuda"])
        torch.cuda.synchronize()
    _check_held("22", held_blends, [], dict(read_counts(), dropout=0))
    eval_s = time.perf_counter() - t0
    eval_counts = held_bn(read_counts(), "22")
    batches = len(paths) * _patch_batches((48, 48, 48), (patch,) * 3,
                                          (patch // 2,) * 3, 4)
    labels = [np.asarray(read_image(p).data) for p in paths]
    say(f"[22] flags.train --attention --dropout_impl bits8: {state.step} "
        f"steps at batch {batch}, {patch}^3, in {train_s:.2f} s; "
        f"{type(state.network).__name__}, {n_dropout} dropout layers; "
        f"sidecar Norm {sidecar['Networks']['Norm']}, DropoutImpl "
        f"{sidecar['Networks']['DropoutImpl']}; launches {train_counts}; "
        f"flags.evaluate: {len(paths)} cases in {eval_s:.2f} s, launches "
        f"{eval_counts} ({batches} patch batches), label values "
        f"{sorted(set(np.unique(np.concatenate([l.ravel() for l in labels]))))}")
    check(state.step == steps, f"trained {state.step} steps")
    check(type(state.network).__name__ == "AttentionGatedVNet",
          "not the attention-gated network")
    check(sidecar["Networks"]["DropoutImpl"] == "bits8"
          and sidecar["Networks"]["Norm"] == "batch", f"sidecar {sidecar}")
    check(train_counts["dropout"] == 2 * n_dropout * steps,
          f"dropout launches {train_counts['dropout']} != "
          f"{2 * n_dropout * steps}")
    check(len(paths) == 2 and all(l.shape == (48, 48, 48) and
                                  set(np.unique(l)) <= {0, 1}
                                  for l in labels), "labels")
    check(eval_counts["blend_accumulate"] == batches,
          f"blend launches {eval_counts['blend_accumulate']} != {batches}")
    return train_counts["dropout"], eval_counts["blend_accumulate"]


def _window_like_the_pipeline(img):
    """``StatisticalNormalization`` (sigma 2.5) of the evaluation pipeline:
    the window ``mean +- 2.5 std`` mapped onto [0, 255], in float64."""
    mean, std = float(img.mean()), float(img.std())
    lo, hi = mean - 2.5 * std, mean + 2.5 * std
    windowed = np.clip((img.astype(np.float64) - lo) * (255.0 / (hi - lo)),
                       0.0, 255.0).astype(np.float32)
    return windowed, lo, hi


def phase_export(tmp):
    from vnet_tpu_torch import export, native
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.infer.evaluator import Evaluator
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid
    from vnet_tpu_torch.io import MedicalImage, read_image, write_image
    from vnet_tpu_torch.models import build_network, eval_apply
    from vnet_tpu_torch.train import checkpoints

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_path, cfg = _write_config(tmp)
    # the native client blends uniformly and has no LCC or threshold
    cfg["EvaluationSetting"].update(
        GaussianBlend=False, LargestConnectedComponent=False,
        VolumeThreshold=0, ProbabilityOutput=False)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    ts = cfg["TrainingSetting"]
    net_cfg = ts["Networks"]
    classes = len(ts["SegmentationClasses"])
    # the f32 check at a cut depth (2 of the 4 levels): its compile took
    # 46-53 s at full depth
    net32 = build_network(
        "VNet", num_classes=classes, num_channels=net_cfg["NumChannel"],
        num_levels=2, num_convolutions=net_cfg["NumConvolutions"][:2],
        bottom_convolutions=net_cfg["BottomConvolutions"],
        norm=net_cfg["Norm"], dropout_rate=0.0, device="cpu",
        generator=torch.Generator().manual_seed(SEED))
    checkpoints.save(ts["CheckpointDir"], build_network(
        "VNet", num_classes=classes, num_channels=net_cfg["NumChannel"],
        num_levels=net_cfg["NumLevels"],
        num_convolutions=net_cfg["NumConvolutions"],
        bottom_convolutions=net_cfg["BottomConvolutions"],
        norm=net_cfg["Norm"], dropout_rate=0.0, device="cpu",
        generator=torch.Generator().manual_seed(SEED)).state_dict(), 0)
    net32.to("cuda")
    ev = Evaluator(load_config(cfg_path), device="cuda")  # bf16, packed
    check(ev.network.dtype == torch.bfloat16, "the config's network is bf16")
    shape = (SLICE_BATCH,) + SLICE_PATCH + (1,)

    reset_counts()
    packages = {}
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(native.build)  # g++ beside Inductor
        for tag, net in (("bf16", ev.network), ("f32", net32)):
            t0 = time.perf_counter()
            program = export.export_forward(net, shape, device="cuda")
            t1 = time.perf_counter()
            packages[tag] = export.compile_package(
                program, os.path.join(tmp, f"forward_{tag}.pt2"))
            t2 = time.perf_counter()
            say(f"[24] {tag} {shape}: torch.export {t1 - t0:.2f} s, "
                f"AOTInductor compile for cuda {t2 - t1:.2f} s, package "
                f"{os.path.getsize(packages[tag])} bytes")
        built = building.result()
    say(f"[24] native build (host library, vnet_infer_torch, C++ tests) "
        f"with g++ against libtorch: compiled={built.compiled} "
        f"{built.seconds:.2f} s ({built.directory.name})")

    img = _synthetic_image(np.random.default_rng(SEED + 24))
    windowed, lo, hi = _window_like_the_pipeline(img)
    starts = build_patch_grid(SLICE_VOLUME, SLICE_PATCH, SLICE_STRIDE)
    x = torch.from_numpy(np.stack([
        windowed[a:a + SLICE_PATCH[0], b:b + SLICE_PATCH[1],
                 c:c + SLICE_PATCH[2]]
        for a, b, c in starts[:SLICE_BATCH]])[..., None]).cuda()
    for tag, net in (("f32", net32), ("bf16", ev.network)):
        ref = torch.softmax(eval_apply(net, x), dim=-1)
        got = export.load_package(packages[tag])(x)
        torch.cuda.synchronize()
        check(got.shape == shape[:-1] + (classes,) and got.is_cuda,
              f"{tag} package output {tuple(got.shape)} on {got.device}")
        check(bool(torch.isfinite(got).all()), f"{tag} package: non-finite")
        diff = (got - ref).abs()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        say(f"[24] {tag} package vs the eager module's softmax on the card, "
            f"one batch of {SLICE_BATCH} windowed patches: max |diff| "
            f"{diff.max().item():.3e}, mean |diff| {diff.mean().item():.3e}, "
            f"equal argmax labels {agree:.6f}")
        if tag == "f32":
            check(diff.max().item() <= EXPORT_F32_ATOL,
                  f"the f32 package is more than {EXPORT_F32_ATOL} off")
        else:
            check(agree >= EXPORT_BF16_AGREE,
                  f"the bf16 package's labels agree on {agree:.6f} < "
                  f"{EXPORT_BF16_AGREE}")
        del got, ref, diff
    del net32, x
    torch.cuda.empty_cache()

    case = os.path.join(tmp, "evaluate", "case_0")
    os.makedirs(case)
    image_path = os.path.join(case, "image.nii")
    write_image(MedicalImage(img, (0.75, 0.75, 0.75)), image_path)
    out = os.path.join(tmp, "label_native.nii")
    cmd = [str(built.infer), image_path, out, "128",
           "x".join(map(str, SLICE_PATCH)), "x".join(map(str, SLICE_STRIDE)),
           "8", packages["bf16"], str(classes), repr(lo), repr(hi), "0.75"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    counts = held_bn(read_counts(), "24")  # the eager references' norms
    for line in proc.stdout.splitlines():
        say(f"[24] vnet_infer_torch: {line}")
    check(proc.returncode == 0,
          f"vnet_infer_torch exited {proc.returncode}: {proc.stderr[-2000:]}")
    check(any(line.startswith("device: cuda")
              for line in proc.stdout.splitlines()),
          "vnet_infer_torch did not run on cuda")
    check(not any(counts.values()),
          f"the export path launched kernels of the port: {counts}")
    seconds = float(next(line.split()[2] for line in proc.stdout.splitlines()
                         if line.startswith("inference time:")))
    label, source = read_image(out), read_image(image_path)
    values = set(np.unique(label.data).tolist())
    check(values <= {0, 1, 2}, f"native label values {values}")
    for get in ("GetSize", "GetSpacing", "GetOrigin", "GetDirection"):
        check(np.allclose(getattr(label, get)(), getattr(source, get)(),
                          atol=1e-6), f"native label {get} differs")

    ev.evaluate_case(case)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    label_py, _ = ev.evaluate_case(case)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    agree = float(np.mean(label.data == label_py.data))
    say(f"[24] vnet_infer_torch, one {'x'.join(map(str, SLICE_VOLUME))} "
        f"volume on the card: "
        f"{seconds:.3f} s (read, window, resample, {len(starts)} patches "
        f"in batches of {SLICE_BATCH}, uniform blend, argmax, resample "
        f"back, write; the first volume of its process), process wall "
        f"{wall:.2f} s; the Python Evaluator on the same case, uniform "
        f"blend, steady: {steady:.3f} s (PR 9: 1.19 s steady with the "
        f"cosine blend, LCC and probability maps); labels equal on "
        f"{agree:.6f} of the voxels (values {sorted(values)}, "
        f"{int(np.count_nonzero(label.data))} foreground)")
    check(agree >= NATIVE_AGREE, f"vnet_infer_torch and the Evaluator agree "
          f"on {agree:.6f} < {NATIVE_AGREE} of the voxels")
    del ev
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 25: Remat
# ----------------------------------------------------------------------
def _remat_check_step(remat):
    """(a): one float32 flagship step at ``REMAT_CHECK_BATCH``; every
    dropout launch held against its plain version, every dropout call's
    ``(layer, dropped)`` recorded (the recompute's after the forward's)."""
    from vnet_tpu_torch.models.layers import Dropout
    from vnet_tpu_torch.tools.profile_step import flagship_step

    state, step, images, labels = flagship_step(
        "pallas", REMAT_CHECK_BATCH, seed=SEED, dtype=torch.float32,
        remat=remat)
    net = state.network
    masks = []
    handles = [m.register_forward_hook(
        lambda m, inp, out: masks.append((m.index, (out == 0)
                                          & (inp[0] != 0))))
        for m in net.modules() if isinstance(m, Dropout)]
    reset_counts()
    with _holding() as (_, drops):
        out = step(state, images, labels, dropout_seed=SEED + 25)
        torch.cuda.synchronize()
    counts = {k: v for k, v in held_bn(read_counts(), "25").items() if v}
    for h in handles:
        h.remove()
    return dict(loss=float(out.loss), masks=masks, drops=drops,
                counts=counts, n=len(net.dropouts),
                grads={k: p.grad.detach().clone()
                       for k, p in net.named_parameters()},
                buffers={k: v.clone() for k, v in net.named_buffers()})


def _remat_cases(tmp):
    from vnet_tpu_torch.utils.synthdata import make_hard_dataset

    make_hard_dataset(tmp, "training", REMAT_CASES,
                      np.random.default_rng(SEED + 25), shape=LITS_CASE)
    with open(TRAIN_CONFIG) as f:
        cfg = json.load(f)
    ts = cfg["TrainingSetting"]
    ts["Data"]["TrainingDataDirectory"] = os.path.join(tmp, "training")
    ts["Data"]["TestingDataDirectory"] = os.path.join(tmp, "training")
    ts.update(MaxIterations=REMAT_STEPS, Restore=False,
              LogDir=os.path.join(tmp, "log"),
              CheckpointDir=os.path.join(tmp, "ckpt"),
              Pipeline=os.path.join(ROOT, ts["Pipeline"]))
    ts["Networks"]["Remat"] = True
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, ts


def phase_remat(tmp):
    """Phase 25; returns the dropout launches of (c), the main path."""
    from vnet_tpu_torch.__main__ import main
    from vnet_tpu_torch.ops.dropout import dropout_params

    # (a) float32, the same kernels on the same inputs
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        plain = _remat_check_step(False)
        remat = _remat_check_step(True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    largest = max(g.abs().max().item() for g in plain["grads"].values())
    grad_err = max((remat["grads"][k] - g).abs().max().item()
                   for k, g in plain["grads"].items())
    buffers_equal = all(torch.equal(remat["buffers"][k], v)
                        for k, v in plain["buffers"].items())
    n = plain["n"]
    forward = dict(remat["masks"][:n])
    fwd_equal = all(i == j and torch.equal(a, b) for (i, a), (j, b) in
                    zip(remat["masks"][:n], plain["masks"]))
    recomputed = remat["masks"][n:]
    rec_equal = all(torch.equal(m, forward[i]) for i, m in recomputed)
    drops = plain["drops"] + remat["drops"]
    say(f"[25] (a) flagship step f32 64^3 batch {REMAT_CHECK_BATCH}, "
        f"pallas, without / with Remat: loss {plain['loss']!r} / "
        f"{remat['loss']!r}; running averages equal {buffers_equal}; "
        f"gradients max |diff| {grad_err:.3e} ({grad_err / largest:.3e} of "
        f"the largest); launches {plain['counts']} / {remat['counts']}; "
        f"{len(recomputed)} recomputed dropout masks equal to their "
        f"forward's {rec_equal}, forward masks equal to the plain "
        f"network's {fwd_equal}; {len(drops)} dropout launches held, "
        f"bitwise {sum(c[0] for c in drops)}/{len(drops)}")
    check(remat["loss"] == plain["loss"], "Remat changed the loss")
    check(buffers_equal, "Remat changed the running averages")
    check(grad_err <= REMAT_GRAD_RTOL * largest,
          f"Remat's gradients are {grad_err / largest:.3e} of the largest "
          f"off the plain network's")
    check(plain["counts"] == {"dropout": 42, "dw_conv": 21}
          and remat["counts"] == {"dropout": 54, "dw_conv": 21},
          f"launches {plain['counts']} / {remat['counts']}")
    check(len(recomputed) == 12 and rec_equal and fwd_equal,
          "a recomputed dropout mask differs from its forward's")
    check(len(plain["drops"]) == 42 and len(remat["drops"]) == 54
          and all(c[0] for c in drops),
          "a dropout launch differs from its plain version")
    del plain, remat, drops, forward, recomputed
    torch.cuda.empty_cache()

    # (b) bf16 at a cut batch: time and memory
    peaks = {}
    for on in (False, True):
        ms, peak, losses, per_step = _flagship_steps("pallas", REMAT_BATCH,
                                                     "packed", remat=on)
        torch.cuda.empty_cache()
        peaks[on] = peak
        say(f"[25] (b) flagship step bf16 64^3 batch {REMAT_BATCH}, pallas, "
            f"Remat {on}: median {ms:.1f} ms, {REMAT_BATCH / ms * 1e3:.1f} "
            f"patches/s, peak memory {peak / 2 ** 30:.2f} GiB, launches a "
            f"step {per_step}; losses {losses}")
        check(all(np.isfinite(losses)), f"losses {losses}")
        check(per_step == {"dropout": 54 if on else 42, "dw_conv": 21},
              f"launches a step {per_step}")
    check(peaks[True] < peaks[False],
          f"Remat's peak memory {peaks[True]} is not below {peaks[False]}")

    # (c) the main path: config.json's training at batch 32 with Remat
    cfg_path, ts = _remat_cases(tmp)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (_, held_drops):
        state = main(["-p", "train", "--config_json", cfg_path, "--device",
                      "cuda"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = held_bn(read_counts(), "25")
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(ts["LogDir"], "train", "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    say(f"[25] (c) python -m vnet_tpu_torch -p train, configs/config.json "
        f"with Remat: true: {REMAT_STEPS} steps at batch "
        f"{ts['BatchSize']}, patch {ts['PatchShape']}, on {REMAT_CASES} "
        f"synthetic {'x'.join(map(str, LITS_CASE))} cases in {wall:.2f} s "
        f"(data loading, build, warm-up, a checkpoint and the held plain "
        f"dropouts included); peak memory {peak / 2 ** 30:.2f} GiB (the "
        f"held plain dropouts' included) on a "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} "
        f"GiB card; losses {losses}; launches {counts}")
    check(state.step == REMAT_STEPS and state.network.remat,
          "the CLI did not train the Remat network")
    check(ts["BatchSize"] == 32 and ts["PatchShape"] == [256, 256, 32],
          "config.json's batch and patch changed")
    check(len(losses) == REMAT_STEPS and all(np.isfinite(losses)),
          f"losses {losses}")
    check(counts["dropout"] == 54 * REMAT_STEPS
          and counts["dropout"] == sum(counts.values()),
          f"launches {counts}, expected {54 * REMAT_STEPS} dropout")
    # forward, recompute and backward, at config.json's shapes
    _check_held("25", [], held_drops, dict(counts, blend_accumulate=0))
    xla = dropout_params(ts["Networks"]["Dropout"], "xla")
    check(ts["Networks"].get("DropoutImpl", "xla") == "xla"
          and {c[3:5] for c in held_drops} == {(xla[2], xla[0])},
          "a dropout on the path is not config.json's xla flavour")
    del state
    torch.cuda.empty_cache()
    return counts["dropout"]



# phase 26: the evaluation and diagnostic tools

def _blend_margin():
    """The blend kernel at a BENCH_MARGIN^3 accumulator (4 and 3 channels,
    both float paths): patches at the far corners, where the offsets are
    largest, bitwise equal to the plain slice-adds."""
    from vnet_tpu_torch.ops.blend import (blend_accumulate_patches,
                                          blend_accumulate_plain)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    edge, p = BENCH_MARGIN, BENCH_PATCH
    far = edge - p
    starts = torch.tensor([[x, y, z] for x in (0, far) for y in (0, far)
                           for z in (0, far)] + [[far - 3, far, far - 5]],
                          dtype=torch.int32)
    for c, width in ((4, 4), (3, 1)):
        acc = torch.zeros((edge,) * 3 + (c,), device=dev)
        contrib = torch.rand((len(starts),) + (p,) * 3 + (c,),
                             generator=gen, device=dev)
        got = blend_accumulate_patches(acc.clone(), contrib, starts)
        taken = blend_accumulate_patches.last_width
        ref = blend_accumulate_plain(acc, contrib, starts)
        torch.cuda.synchronize()
        equal = torch.equal(got, ref)
        corner = got[-1, -1, -1].sum().item()
        say(f"[26] blend at a {edge}^3 accumulator, {c} channels "
            f"({got.numel() * 4 / 2 ** 30:.2f} GiB, {got.numel()} floats): "
            f"{len(starts)} patches at the far corners, width {taken}, "
            f"bitwise_equal={equal}, last element's sum {corner:.4f}")
        check(equal and taken == width and corner > 0,
              f"the blend at {edge}^3 x {c}: equal {equal}, width {taken}")
        del acc, contrib, got, ref


def phase_bn_act():
    """Phase 28: the fused batch norm + activation kernels at the cells'
    sites, the level-0 site's times, a traced step's launches and export
    (the module docstring). Returns the kernels line's entry."""
    from vnet_tpu_torch.tools import bn_act_bench as bab

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sites = [((shape, groups, act), layers, train)
             for cell, (_, _, _, train) in bab.CELLS.items()
             for (shape, groups, act), layers in bab.bn_sites(cell)]
    sites += [(site, 0, True) for site in bab.EDGE_SITES]
    worst = {}
    for (shape, groups, act), _, train in sites:
        r = bab.check_site(shape, groups, act, gen, train)
        for k, v in r.items():
            if isinstance(v, float):
                worst[k] = max(worst.get(k, 0.0), v)
        torch.cuda.empty_cache()
    say(f"[28] {len(sites)} sites held against the plain versions (apply "
        f"bitwise, running averages bitwise); worst: {worst}")
    level0 = ((32, 128, 128, 128, 16), 8, "prelu")
    times = bab.site_ms(*level0, gen)
    torch.cuda.empty_cache()
    say(f"[28] level-0 packed site {level0}: {json.dumps(times)}")
    steps = {}
    for make, remat in (("flagship", True), ("flagship", False),
                        ("attention", False)):
        label = f"{make}{' remat' if remat else ''}"
        try:
            r = bab.check_step(make, remat)
        except AssertionError as e:
            check(False, f"{label} step: launches not once per site per "
                         f"pass, or a kernel named like another: {e}")
        say(f"[28] {label} step: batch-norm calls {r['calls']}, launches "
            f"(moments, apply, sums, dx) {r['launches']}; trace "
            f"{r['trace']}")
        steps[label] = dict(sites=r["calls"]["forward"],
                            recompute=r["calls"]["recompute"],
                            launches=sum(r["launches"]))
    err = bab.check_export(SEED)
    say(f"[28] export_forward on cuda: no fused launch in the program, max "
        f"|diff| against the module {err:.3e}")
    say(f"[28] phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(ms=times["kernel_fwd_ms"] + times["kernel_bwd_ms"],
                bound_ms=times["bound_fwd_ms"] + times["bound_bwd_ms"],
                bound_by="bytes", plain_ms=times["eager_fwd_ms"]
                + times["eager_bwd_ms"], times=times, steps=steps,
                worst=worst)


def phase_tools_trace():
    """Phase 26 (c) and the blend at (a)'s geometry, with the process's
    other traces before its first CLI run: the blend kernel at
    ``tools/benchmark_eval.py``'s 512^3 geometry (one launch of 128 64^3
    patches into the 2 GiB accumulator) against its plain version and
    timed, the BENCH_MARGIN^3 margin, then ``tools/analyze_trace.py`` over
    a ``profiler.TraceCapture`` trace of one warm 512^3 engine call; the
    blend kernel's readings at 512^3."""
    import io
    import pathlib

    from vnet_tpu_torch.infer.sliding_window import build_patch_grid
    from vnet_tpu_torch.profiler import TraceCapture
    from vnet_tpu_torch.tools import analyze_trace
    from vnet_tpu_torch.tools import benchmark_eval as be

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (BENCH_SIZE,) * 3
    grid = build_patch_grid(shape, (BENCH_PATCH,) * 3, (BENCH_STRIDE,) * 3)
    check(len(grid) == 4 * BENCH_BATCH, f"{len(grid)} patches at 512^3")
    err, ms, plain_ms, bound_ms, call_ms = _kernel_vs_plain(
        shape + (4,), (BENCH_PATCH,) * 3, grid[:BENCH_BATCH], gen,
        "benchmark_eval's 512^3 geometry", 4, tag="26")
    torch.cuda.empty_cache()
    _blend_margin()
    torch.cuda.empty_cache()

    engine, _ = be.build_engine(BENCH_PATCH, BENCH_STRIDE, BENCH_BATCH, 3,
                                blend_impl="pallas", device="cuda")
    vol, _ = be.resident_volume(BENCH_SIZE, "cuda")
    engine(vol)[1].sum().item()  # the first call: cuDNN's warm-up
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_trace_")
    try:
        with TraceCapture(tmp, "cuda") as trace:
            time.sleep(TRACE_PADS_S[3])
            engine(vol)[1].sum().item()
            time.sleep(TRACE_PADS_S[3])
        summary = analyze_trace.summarize(
            analyze_trace.read_events(pathlib.Path(trace.path)))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = analyze_trace.main([tmp, "--group", "--top", "8"])
        size = os.path.getsize(trace.path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for line in out.getvalue().splitlines():
        if line.strip():
            say(f"[26] analyze_trace: {line}")
    busy, ops = summary["busy_ms"], summary["ops"]
    ranked = sorted(ops, key=lambda k: -ops[k][0])
    blend = [k for k in ranked if "blend_accumulate_kernel" in k]
    grouped = sum(summary["groups"].values())
    trace_ms = sum(ops[k][0] for k in blend) / max(1, sum(ops[k][1]
                                                          for k in blend))
    say(f"[26] trace of one 512^3 engine call ({size / 2 ** 20:.1f} MiB): "
        f"busy {busy:.3f} ms over {summary['events']} device events, groups "
        f"sum {grouped:.3f} ms; blend launches in it "
        f"{sum(ops[k][1] for k in blend)}, {trace_ms:.4f} ms a launch, rank "
        f"{[ranked.index(k) + 1 for k in blend]} of {len(ranked)} kernels")
    check(code == 0 and busy > 0, f"analyze_trace: code {code}, busy {busy}")
    check(blend and ranked.index(blend[0]) < 25,
          "the blend kernel is not among the trace's top 25 ops")
    check(sum(ops[k][1] for k in blend) == 4, "not 4 blend launches traced")
    check(grouped >= busy * (1 - 1e-9), f"groups {grouped} < busy {busy}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, call_ms=call_ms,
                max_abs_err=err, engine_trace_ms=trace_ms,
                share_of_bound=bound_ms / ms,
                shape="128 x (64, 64, 64, 4) into (512, 512, 512, 4)")


def _eval2d_modes(stack, dtype):
    """Phase 26 (b) at one dtype: ``experiments/eval2d.py``'s engines,
    the stacked call held (every blend launch bitwise), then one call a
    slice; ``(blend launches, readings)``: the two modes' largest
    probability difference, their label agreement, flips where the top
    two probabilities differ by more than ``DP_LABEL_GAP`` or by more than
    twice that difference, and the logits of the same patches at other
    rows of other batches, as the two modes place them."""
    from vnet_tpu_torch.experiments import eval2d
    from vnet_tpu_torch.infer.sliding_window import build_patch_grid
    from vnet_tpu_torch.models import eval_apply

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        stacked, per_slice, net = eval2d.build_engines(256, 128, 16, 3,
                                                       "cuda", dtype=dtype)
        reset_counts()
        t0 = time.perf_counter()
        with _holding() as (blends, drops):
            acc_s, w_s = stacked(stack)
            torch.cuda.synchronize()
        stacked_s = time.perf_counter() - t0
        counts = held_bn(read_counts(), "26")
        _check_held("26", blends, drops, counts)
        grid = build_patch_grid(STACK_2D[1:3], (256, 256), (128, 128))
        rows = STACK_2D[0] * len(grid)
        check(counts["blend_accumulate"] == -(-rows // 16),
              f"stacked blend launches {counts}, {rows} rows")
        t0 = time.perf_counter()
        per = [per_slice(stack[z]) for z in range(STACK_2D[0])]
        acc_p = torch.stack([a for a, _ in per])
        w_p = torch.stack([w for _, w in per])
        torch.cuda.synchronize()
        per_s = time.perf_counter() - t0
        n_per = read_counts()["blend_accumulate"] - counts["blend_accumulate"]
        check(n_per == STACK_2D[0], f"per-slice launches {n_per}")
        check(torch.equal(w_s, w_p), "the two modes' blend weights differ")
        prob_s, prob_p = acc_s / w_s[..., None], acc_p / w_p[..., None]
        diff = (prob_s - prob_p).abs().max().item()
        top2 = torch.topk(prob_p, 2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        flips = torch.argmax(acc_s, -1) != torch.argmax(acc_p, -1)
        # the stacked first batch is slice 0's 9 patches and slice 1's
        # first 7; per slice, slice 1's batch is its 9 and the last one
        # repeated: the same 7 patches at rows 9-15 and at rows 0-6
        k = len(grid)

        def patches(z):
            return [stack[z, x:x + 256, y:y + 256] for x, y in grid.tolist()]

        first = eval_apply(net, torch.stack(patches(0) + patches(1)[:16 - k]))
        own = eval_apply(net, torch.stack(patches(1) + patches(1)[-1:]
                                          * (16 - k)))
        out_s, out_p = first.float()[k:], own.float()[:16 - k]
        readings = dict(
            dtype=str(dtype), prob_diff=diff,
            agreement=1.0 - flips.float().mean().item(),
            flips=int(flips.sum()),
            decided_flips=int((flips & (gap > DP_LABEL_GAP)).sum()),
            flips_beyond=int((flips & (gap > 2 * diff)).sum()),
            logit_diff=(out_s - out_p).abs().max().item(),
            logit_max=out_p.abs().max().item(),
            stacked_s=stacked_s, per_slice_s=per_s)
        say(f"[26] (b) eval2d {STACK_2D[:3]} {dtype}: stacked {stacked_s:.2f}"
            f" s (held, first call) with {counts['blend_accumulate']} "
            f"launches, per slice {per_s:.2f} s with {n_per}; max prob diff "
            f"{diff:.3e}, labels agree on {readings['agreement']:.6f} "
            f"({readings['flips']} flips, {readings['decided_flips']} where "
            f"the top two differ by more than {DP_LABEL_GAP:g}); slice 1's "
            f"first 7 patches at rows 9-15 of a batch and at rows 0-6 of "
            f"another: max |logit diff| "
            f"{readings['logit_diff']:.3e} of {readings['logit_max']:.3e}")
        return counts["blend_accumulate"] + n_per, readings
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def phase_tools(qs_workdir):
    """Phase 26 (a), (b), (d), (e): the tools' main paths on the card; the
    blend launches of their runs."""
    import io

    from vnet_tpu_torch.experiments import (compare_preds, eval_only,
                                            patch_diagnose)
    from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference
    from vnet_tpu_torch.tools import benchmark_eval as be

    launches = 0
    # (a) benchmark_eval's engine at 512^3, the kernel and the plain blend
    engine, _ = be.build_engine(BENCH_PATCH, BENCH_STRIDE, BENCH_BATCH, 3,
                                blend_impl="pallas", device="cuda")
    plain = SlidingWindowInference(
        engine.apply_fn, engine.patch_shape, engine.stride, BENCH_BATCH, 3,
        blend_impl="xla", device="cuda")
    vol, copy_s = be.resident_volume(BENCH_SIZE, "cuda")
    check(engine.device_volume(vol).data_ptr() == vol.data_ptr(),
          "the engine copies a resident volume")
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (blends, drops):
        acc_k, w_k = engine(vol)
        torch.cuda.synchronize()
    held_s = time.perf_counter() - t0
    counts = held_bn(read_counts(), "26")
    _check_held("26", blends, drops, counts)
    check(counts["blend_accumulate"] == 4 and not drops,
          f"launches {counts} at 512^3, expected 4 blends")
    launches += counts["blend_accumulate"]
    acc_x, w_x = plain(vol)
    scale = acc_x.abs().max().item()
    diff = (acc_k - acc_x).abs().max().item()
    same = torch.equal(torch.argmax(acc_k, -1), torch.argmax(acc_x, -1))
    say(f"[26] (a) 512^3 stride {BENCH_STRIDE} batch {BENCH_BATCH}: copy "
        f"{copy_s:.4f} s; first call (held) {held_s:.2f} s; pallas vs xla: "
        f"labels equal {same}, max |acc diff| {diff:.3e} of {scale:.3e}, "
        f"weights equal {torch.equal(w_k, w_x)}")
    check(same and diff <= BENCH_RTOL * scale and torch.equal(w_k, w_x),
          "the 512^3 engine's blends disagree")
    del acc_k, w_k, acc_x, w_x
    readings = {}
    for name, eng in (("pallas", engine), ("xla", plain)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()["blend_accumulate"]
        first, times = be.timed_reps(eng, vol, BENCH_REPS)
        n = read_counts()["blend_accumulate"] - before
        launches += n
        readings[name] = dict(
            median_s=statistics.median(times), times_s=times, first_s=first,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            blend_launches=n)
        say(f"[26] (a) {name}: median {readings[name]['median_s']:.4f} s of "
            f"{times}, first {first:.4f} s, peak "
            f"{readings[name]['peak_gib']:.2f} GiB, blend launches {n}")
    check(readings["pallas"]["blend_launches"] == 4 * (1 + BENCH_REPS)
          and readings["xla"]["blend_launches"] == 0,
          f"blend launches {readings}")
    del vol, engine, plain
    torch.cuda.empty_cache()

    # (b) eval2d: stacked against per-slice, in the tool's bf16 and in
    # float32 with TF32 off
    stack = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=STACK_2D).astype(np.float32)).to("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        n, readings_2d = _eval2d_modes(stack, dtype)
        launches += n
        if dtype == torch.float32:
            check(readings_2d["prob_diff"] <= DP_PROB_ATOL
                  and readings_2d["decided_flips"] == 0,
                  f"eval2d float32: stacked and per-slice differ "
                  f"{readings_2d}")
        else:
            check(readings_2d["prob_diff"] <= EVAL2D_BF16_ATOL
                  and readings_2d["flips_beyond"] == 0,
                  f"eval2d bf16: stacked and per-slice differ {readings_2d}")
    del stack
    torch.cuda.empty_cache()

    # (d) benchmark_loader, in processes of their own (the process
    # backend forks a process without the card's context)
    for backend in ("thread", "process"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vnet_tpu_torch.tools.benchmark_loader",
             "--cases", str(LOADER_CASES), "--size", *map(str, LOADER_SIZE),
             "--batch", str(LOADER_BATCH), "--batches", str(LOADER_BATCHES),
             "--backend", backend],
            cwd=ROOT, capture_output=True, text=True,
            timeout=LOADER_TIMEOUT)
        check(proc.returncode == 0, f"benchmark_loader --backend {backend}: "
                                    f"{proc.stderr[-2000:]}")
        rows_out = [json.loads(x) for x in proc.stdout.splitlines()
                    if x.startswith("{")]
        for r in rows_out:
            say(f"[26] (d) loader {backend} {r['variant']}: "
                f"{r['patches_per_s']:.2f} patches/s, {r['workers']} "
                f"workers, {r['host_cpus']} host CPUs")
        check([r["variant"] for r in rows_out] == ["full", "lean", "cached",
                                                   "confidence"]
              and all(r["patches_per_s"] > 0 for r in rows_out),
              f"loader {backend}: {rows_out}")
        say(f"[26] (d) loader {backend}: {time.perf_counter() - t0:.1f} s")

    # (e) the diagnostics on phase 21's quickstart workdir
    evaluate = os.path.join(qs_workdir, "evaluate")
    for impl in ("pallas", "xla"):
        out = io.StringIO()
        reset_counts()
        with _holding() as (blends, drops), contextlib.redirect_stdout(out):
            code = eval_only.main(["--workdir", qs_workdir, "--blend-impl",
                                   impl, "--suffix", impl, "--device",
                                   "cuda"])
            torch.cuda.synchronize()
        counts = held_bn(read_counts(), "26")
        for line in out.getvalue().splitlines():
            say(f"[26] (e) eval_only: {line}")
        _check_held("26", blends, drops, counts)
        check(code == 0 and (counts["blend_accumulate"] > 0)
              == (impl == "pallas"), f"eval_only {impl}: {code}, {counts}")
        launches += counts["blend_accumulate"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = compare_preds.main(["compare_preds", evaluate,
                                   "pred_xla.nii.gz", "pred_pallas.nii.gz"])
    for line in out.getvalue().splitlines():
        say(f"[26] (e) compare_preds: {line}")
    check(code == 0, "the two blends' predictions disagree")
    case = sorted(os.listdir(evaluate))[0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = patch_diagnose.main(["--workdir", qs_workdir, "--case",
                                    f"evaluate/{case}", "--device", "cuda"])
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"[26] (e) patch_diagnose: {line}")
    check(code == 0 and lines[-1].startswith("blended (uniform) dice")
          and sum(x.startswith("patch ") for x in lines) > 0,
          "patch_diagnose")
    return launches, readings


def _lines_of(main, argv, tag):
    """Exit code and output lines of a tool's ``main(argv)``, each echoed
    with the phase's tag."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"[27] {tag}: {line}")
    return code, lines


def _prefixes(lines, prefixes) -> bool:
    return [x[:len(p)] for x, p in zip(lines, prefixes)] == list(prefixes) \
        and len(lines) == len(prefixes)


def phase_probes_ab(tmp):
    """Phase 27: the 2D quality probes on a full-width 2D quickstart
    workdir, the A/B trio on the flagship step; ``(dropout launches, dW
    launches, blend launches)`` of its main paths."""
    from vnet_tpu_torch import quickstart
    from vnet_tpu_torch.experiments import ab_train
    from vnet_tpu_torch.experiments.diag2d import (oracle2d_r5,
                                                   oracle2d_sweep,
                                                   probe2d_r5, probe2d_r5b,
                                                   probe2d_r5c)
    from vnet_tpu_torch.models import build_network
    from vnet_tpu_torch.tools import analyze_trace, select_bench_tuning

    t_phase = time.perf_counter()
    tuning_path = os.path.join(ROOT, "configs", "bench_tuning.json")
    with open(tuning_path, "rb") as f:
        tuning_bytes = f.read()
    n_dropout_2d = len(build_network(
        "VNet", num_classes=3, spatial_rank=2, device="cpu").dropouts)

    # (a) the probes' workdir: the 2D quickstart at full width
    wd = os.path.join(tmp, "q2d")
    reset_counts()
    t0 = time.perf_counter()
    with _holding() as (held_blends, held_drops):
        result = quickstart.main(["--workdir", wd, "--steps", str(Q2D_STEPS),
                                  "--rank2", "--n-train", str(Q2D_TRAIN),
                                  "--drop-ratio", "0.3", "--min-pixel", "4",
                                  "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = held_bn(read_counts(), "27")
    out = result["quickstart"]
    with open(os.path.join(wd, "config.json")) as f:
        cfg = json.load(f)
    ts, es = cfg["TrainingSetting"], cfg["EvaluationSetting"]
    cases = sorted(os.listdir(os.path.join(wd, "evaluate")))
    # slice-stacked: every z-slice of a 96x96x64 case is one 96^2 patch
    batches = 2 * len(cases) * -(-64 // es["BatchSize"])
    say(f"[27] (a) quickstart --rank2, full width: {out['steps']} steps at "
        f"batch {out['batch']}, patch {out['patch']}, in {wall:.2f} s "
        f"(wall {out['wall']}); dice {out['dice']}; launches {counts}; "
        f"{n_dropout_2d} dropout layers; {batches} patch batches")
    check(out["steps"] == Q2D_STEPS and ts["Precision"] == "bfloat16"
          and ts["BatchSize"] == 32 and ts["PatchShape"] == [96, 96]
          and ts["Networks"]["NumChannel"] == 16
          and ts["Networks"]["NumLevels"] == 4
          and ts["Networks"]["Dropout"] == 0.01, "not the full-width 2D "
                                                 "recipe")
    check(counts["dropout"] == 2 * n_dropout_2d * Q2D_STEPS,
          f"2D dropout launches {counts['dropout']} != "
          f"{2 * n_dropout_2d * Q2D_STEPS}")
    check(counts["blend_accumulate"] == batches,
          f"2D blend launches {counts['blend_accumulate']} != {batches}")
    check(sorted(out["dice"]) == ["batch_stats", "ema"]
          and _dice_ok(out["dice"]), f"dice {out['dice']}")
    _check_held("27", held_blends, held_drops, counts)
    drops, blends = counts["dropout"], counts["blend_accumulate"]

    # (b) the five diag2d tools on that workdir
    t0 = time.perf_counter()
    code, lines = _lines_of(oracle2d_r5.main, ["--workdir", wd],
                            "oracle2d_r5")
    check(code == 0 and _prefixes(lines, ["oracle pooled dice: class1 "]
                                  + [f"{c}: oracle dice [" for c in cases]),
          "oracle2d_r5")
    code, lines = _lines_of(oracle2d_sweep.main, ["--contrasts", "2.0",
                                                  "--n-cases", "1"],
                            "oracle2d_sweep")
    check(code == 0 and _prefixes(lines, ["contrast 2.0: oracle pooled "
                                          "dice class1 "]), "oracle2d_sweep")
    probe_args = ["--workdir", wd, "--device", "cuda"]
    reset_counts()
    code, lines = _lines_of(probe2d_r5.main, probe_args, "probe2d_r5")
    check(code == 0 and _prefixes(lines, ["A  ", "B  ", "C  ", "C1 "]),
          "probe2d_r5")
    with _holding() as (held_blends, held_drops):
        code, lines = _lines_of(probe2d_r5b.main, probe_args, "probe2d_r5b")
        torch.cuda.synchronize()
    r5b = held_bn(read_counts(), "27")
    check(code == 0 and _prefixes(lines, ["eval_apply (train=False): ",
                                          "train-mode (train=True) : "]),
          "probe2d_r5b")
    check(r5b["dropout"] == n_dropout_2d and r5b["dw_conv"] == 0,
          f"probe2d_r5b launches {r5b}, expected {n_dropout_2d} dropouts")
    _check_held("27", held_blends, held_drops, r5b)
    drops += r5b["dropout"]
    reset_counts()
    code, lines = _lines_of(probe2d_r5c.main, [wd, "--device", "cuda"],
                            "probe2d_r5c")
    check(code == 0 and _prefixes(
        lines, ["A train", "A class 1", "A class 2", "A2 unaug",
                "A2 class 1", "A2 class 2", "A2 inventory", "B eval",
                "B class 1", "B class 2", "B empty", "D eval", "D class 1",
                "D class 2", "E eval"]), "probe2d_r5c")
    check(read_counts()["dropout"] == 0, "an evaluation probe launched "
                                         "dropout")
    say(f"[27] (b) diag2d tools: {time.perf_counter() - t0:.2f} s")

    # (c) ab_train in this process, then its CLI and capture_trace
    log = os.path.join(tmp, "ab.log")
    dws = 0
    for tag in AB_TAGS:
        v = ab_train.VARIANTS[tag]
        steps = v["scan"] * (1 + AB_REPS)
        reset_counts()
        t0 = time.perf_counter()
        code, lines = _lines_of(ab_train.main, [
            tag, "--log", log, "--reps", str(AB_REPS), "--device", "cuda",
            "--inproc"], "ab_train")
        counts = held_bn(read_counts(), "27")
        say(f"[27] (c) {tag}: {steps} steps in {time.perf_counter() - t0:.2f}"
            f" s; launches {counts}")
        rec = json.loads(lines[-1])
        check(code == 0 and rec["exp"] == tag and rec["batch"] == 96
              and rec["side"] == 64 and rec["patches_per_s"] > 0,
              f"ab_train {tag}: {code}, {lines}")
        check(counts["dropout"] == 2 * 21 * steps,
              f"{tag}: dropout launches {counts['dropout']} != "
              f"{2 * 21 * steps}")
        n_dw = 21 * steps if v["dw"] == "pallas" else 0
        check(counts["dw_conv"] == n_dw,
              f"{tag}: dW launches {counts['dw_conv']} != {n_dw}")
        drops += counts["dropout"]
        dws += counts["dw_conv"]
    gc.collect()
    torch.cuda.empty_cache()  # the children below need the card's memory
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vnet_tpu_torch.experiments.ab_train",
         "smoke_b2_k1", "--log", log, "--reps", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=AB_TIMEOUT)
    for line in proc.stdout.splitlines():
        say(f"[27] (c) ab_train CLI: {line}")
    check(proc.returncode == 0 and ab_train._logged_tags(log)
          == set(AB_TAGS) | {"smoke_b2_k1"},
          f"ab_train CLI: {proc.returncode} {proc.stderr[-2000:]}")
    trace_dir = os.path.join(tmp, "trace_ab")
    proc = subprocess.run(
        [sys.executable, "-m", "vnet_tpu_torch.experiments.capture_trace",
         "base_b96_k4", "--trace-dir", trace_dir, "--reps", "1"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=AB_TIMEOUT)
    check(proc.returncode == 0, f"capture_trace: {proc.stderr[-2000:]}")
    say(f"[27] (c) capture_trace: {proc.stdout.strip().splitlines()[-1]}")
    summary = analyze_trace.summarize(analyze_trace.read_events(
        analyze_trace.find_trace(trace_dir)))
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:5]
    say(f"[27] (c) analyze_trace: busy {summary['busy_ms']:.2f} ms over "
        f"{summary['events']} device events; top {top}; groups "
        f"{summary['groups']}; CLI and trace {time.perf_counter() - t0:.2f} s")
    names = list(summary["ops"])
    check(summary["busy_ms"] > 0
          and any("dropout_kernel" in n for n in names)
          and not any(n.startswith("dw_") or "dw_mma" in n for n in names),
          "the trace of base_b96_k4 holds no dropout kernel, or a dW kernel")

    # (d) the selector over (c)'s log, into the phase's directory
    out_path = os.path.join(tmp, "bench_tuning_torch.json")
    code, lines = _lines_of(select_bench_tuning.main,
                            ["--log", log, "--out", out_path],
                            "select_bench_tuning")
    with open(tuning_path, "rb") as f:
        unchanged = f.read() == tuning_bytes
    check(code == 0 and lines[-1] == "WINNER_SELECTED"
          and os.path.isfile(out_path) and unchanged,
          f"select_bench_tuning: {code}; configs/bench_tuning.json "
          f"unchanged {unchanged}")
    say(f"[27] phase: {time.perf_counter() - t_phase:.1f} s")
    return drops, dws, blends

def run():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke "
                 "run needs a CUDA card")
    import vnet_tpu_torch  # noqa: F401  (fails outside a checkout)

    card, smi = phase_device_and_build()
    phase_cuda_tests()
    # every torch.profiler trace of this process before the first CLI run:
    # on the H100 machine, a trace taken after one now and then held no
    # device events in six tries
    blend, blend_2d = phase_kernel_vs_plain(card)
    rows, n_rows = phase_rows()
    blend_512 = phase_tools_trace()
    bnact = phase_bn_act()
    phase_forward_card_vs_cpu()
    phase_packed_vs_direct()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_")
    try:
        launches, _, _ = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drop = phase_dropout()
    dw = phase_dw()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_train_")
    try:
        train_counts, train_bn = phase_train(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_flagship()
    (stats, grad_stats), (n_stats, n_grad) = phase_bn()
    tail, n_tail = phase_tail()
    att_drops, _, _ = phase_attention_step()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_2d_")
    try:
        drops_2d, blends_2d, _, _ = phase_2d_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, _, drop_2d = phase_2d_shapes()
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_att_cli_")
    try:
        phase_attention_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_zoo_")
    try:
        phase_zoo(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_dp_")
    try:
        phase_data_parallel(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_sp_")
    try:
        sp_drops = phase_spatial(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # phase 21's workdir stays for phase 26 (e)
    qs_tmp = tempfile.mkdtemp(prefix="vnet_smoke_quickstart_")
    try:
        qs_drops, qs_blends = phase_quickstart(qs_tmp)
        tmp = tempfile.mkdtemp(prefix="vnet_smoke_flags_")
        try:
            fl_drops, fl_blends = phase_flags(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix="vnet_smoke_export_")
        try:
            phase_export(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix="vnet_smoke_remat_")
        try:
            remat_drops = phase_remat(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tool_blends, bench_eval = phase_tools(os.path.join(qs_tmp, "q3"))
    finally:
        shutil.rmtree(qs_tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="vnet_smoke_probes_ab_")
    try:
        ab_drops, ab_dws, ab_blends = phase_probes_ab(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drop_rows, drop_sums = phase_dropout_times()

    def timed(shape, impl):
        r = next(r for r in drop_rows if tuple(r["shape"]) == shape
                 and r["impl"] == impl)
        return dict(ms=r["device_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=r["library_device_ms"],
                    event_ms=r["event_ms"], call_ms=r["call_ms"],
                    host_us=r["host_us"])

    drop.update(timed(FLAGSHIP_DROP, "xla"),
                per_shape=drop_rows, per_step=drop_sums)
    drop_2d.update(timed(DROP_2D, "xla"))
    own = "its own phase ({}); no entry point reaches it"
    say(json.dumps({"kernels": [
        dict(name="blend_accumulate_patches", route="cuda",
             source="vnet_tpu_torch/csrc/blend_accumulate.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:220",
             launches=(launches + blends_2d + qs_blends + fl_blends
                       + tool_blends + ab_blends),
             launches_in="phase 4 (3D evaluation), phase 15 (2D "
                         "evaluation, slice-stacked), phase 21 (the "
                         "quickstart's 3D and 2D evaluations), phase 22 "
                         "(flags.evaluate), phase 26 (benchmark_eval's "
                         "512^3 engine, eval2d stacked and per slice, "
                         "eval_only) and phase 27 (the full-width 2D "
                         "quickstart's evaluations)",
             at_2d=dict(shape="10 x (1, 256, 256, 3) into (64, 384, 384, 3)",
                        **blend_2d),
             at_512=dict(benchmark_eval=bench_eval, **blend_512), **blend),
        dict(name="pallas_dropout", route="cuda",
             source="vnet_tpu_torch/csrc/dropout.cu",
             replaces="vnet_tpu/ops/pallas/dropout.py:99",
             launches=(train_counts["dropout"] + att_drops + drops_2d
                       + sp_drops + qs_drops + fl_drops + remat_drops
                       + ab_drops),
             launches_in="phase 7 (training, pallas flavour), phase 13 "
                         "(attention step, xla flavour), phase 15 (2D "
                         "training, xla flavour), phase 23 (the spatially "
                         "partitioned step on two ranks, pallas flavour, "
                         "row-mapped), phase 21 (the quickstart, "
                         "xla flavour), phase 22 (flags.train "
                         "--attention, bits8 flavour) and phase 25 "
                         "(config.json's training with Remat, xla "
                         "flavour, forward, recompute and backward) and "
                         "phase 27 (the full-width 2D quickstart and "
                         "probe2d_r5b's train-mode forward, xla flavour; "
                         "ab_train's base_b96_k4, xla, and pdw_b96_k16, "
                         "bits8)",
             times_are="xla flavour at (96, 128, 32, 32, 32) bf16: device "
                       "ms a launch, the median of a profiler trace "
                       "(event_ms: CUDA events around 50 launches; call_ms: "
                       "around one wrapper call, host time included; "
                       "host_us: the wrapper's host time a call); "
                       "per_shape: every "
                       "dropout shape of the packed flagship, attention and "
                       "2D steps; per_step: launches x device ms summed",
             at_2d=dict(shape="(32, 64, 128, 128) bf16 channels-last, xla",
                        **drop_2d), **drop),
        dict(name="dw_conv_pallas", route="cuda",
             source="vnet_tpu_torch/csrc/dw_conv.cu",
             replaces="vnet_tpu/ops/pallas/dw_conv.py:209",
             launches=train_counts["dw_conv"] + ab_dws,
             launches_in="phase 7 (training, packed) and phase 27 "
                         "(ab_train's pdw_b96_k16)",
             times_are="per packed training step: launches per step x ms, "
                       "summed over phase 6's nine packed shapes", **dw),
        dict(name="bn_stats", route="cuda",
             source="vnet_tpu_torch/csrc/bn_stats.cu",
             replaces="vnet_tpu/ops/pallas/fused.py:96",
             launches=n_stats + train_bn["bn_stats"],
             launches_in="phase 7 (training: every batch norm's forward "
                         "sums, ops/bn_act.py) and phase 9 "
                         "(batch_norm_train)", **stats),
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
             launches_in=own.format("phase 11, slice geometry"), **rows),
        dict(name="bn_act", route="cuda",
             source="vnet_tpu_torch/csrc/bn_act.cu",
             replaces="none: the JAX package leaves BatchNorm and the "
                      "activation to XLA's fusion",
             launches=sum(train_bn[k] for k in BN_ACT if k != "bn_stats"),
             launches_in="every batch-kind norm of every network on the "
                         "card; counted here: phase 7's training (wrapper "
                         "calls of the apply, the gradient sums and dx; "
                         "the forward's sums are bn_stats')",
             times_are="event ms of the level-0 packed site (32, 128, "
                       "128, 128, 16) bf16 PReLU, forward (moments, "
                       "apply) plus backward (sums, dx); plain_ms: the "
                       "eager chain it replaced", **bnact)]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    run()
