"""``SwinUNETR`` (``vnet_tpu_torch/models/swin_unetr.py``) against the
benchmark's plain reference (``portbench/reference/swin_unetr_btcv.py``)
on the CPU, its window attention's plain version against the reference's
explicit attention, the shipped config and the trainer and evaluator
CLI (``tests/test_torch_swin_parallel.py`` holds its data-parallel step).

The small case: a 32^3 patch, ``feature_size`` 12 and the published depths
(2, 2, 2, 2), heads (3, 6, 12, 24) and window 7^3, so that stage 1 (16^3)
and stage 2 (8^3) pad to 21^3 and 14^3 and shift with the mask, stage 3
(4^3) and stage 4 (2^3) clamp their windows and index the 7^3 window's
bias index sliced, and every stage merges; 14 classes (labels 0-2, as the
benchmark's data fills them), batch 2, float32, weights from
``yardstick.data.make_weights``, ``Remat`` on.

Tolerances, with their reasons (both sides float32 on the CPU; the port
computes the same operations in another layout and order: channels-last
convolutions, instance norm statistics over a ``(B, S, C)`` view, the
closed-form instance-norm backward against autograd's):

* logits within ``1e-5`` of their largest magnitude, the loss to a
  relative ``1e-5``;
* each leaf's gradient within ``GRAD_RTOL = 5e-4`` of the largest entry of
  the reference's (measured 4.2e-5, float32 sums through 20 layers of
  recompute and residual adds; the worst leaves are the stage-4 bias
  tables, whose entries are sums of the fewest terms).

The three planted faults (the shift mask dropped, the bias index
transposed, the clamped windows given their own index instead of MONAI's
sliced 7^3 one) must move some leaf's gradient by more than
``FAULT_FACTOR`` times that tolerance. ``compare.train_numbers``, which
compares the norms of the leaves' gradients, reads them in float32 at
``make_weights``' scales too (``PERF.md``).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from fixtures import make_dataset_dir
from portbench.reference import swin_unetr_btcv as ref
from portbench.reference import vnet3d_liver as base
from portbench.yardstick import data
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.config import load_config, parse_config
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.models import swin_unetr as su
from vnet_tpu_torch.ops import window_attention as wa
from vnet_tpu_torch.ops.losses import segmentation_loss
from vnet_tpu_torch.train import checkpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = (32, 32, 32)
FEATURE = 12
CLASSES = 14
BATCH = 2
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs in several workers at once,
    and these 3D convolutions on every core of each worker thrash."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-4
FAULT_FACTOR = 4.0
NET = {"in_channels": 1, "num_channel": FEATURE, "num_classes": CLASSES}


@pytest.fixture(scope="module")
def case():
    """The weights, the batch and the reference's logits, loss and
    gradients."""
    weights = data.make_weights(ref.named_shapes(NET), SEED, "cpu")
    batch = data.train_batch(SEED, 0, BATCH, PATCH, 1, CLASSES, False, "cpu")
    images = torch.from_numpy(batch["images"])
    labels = torch.from_numpy(batch["labels"])
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ctx = base.Ctx(P, "train", base.rounding("float32"), ckpt=True)
    logits = ref.network(ctx, NET, images)
    value = ref.loss(logits, {"labels": labels},
                     {"network": NET, "loss": {"alpha": 1.0}})
    value.backward()
    return {"weights": weights, "images": images, "labels": labels,
            "logits": logits.detach(), "loss": float(value.detach()),
            "grads": {k: p.grad for k, p in P.items()}}


def _port(case):
    """The port's logits, loss and gradients on the case."""
    net = build_network("SwinUNETR", num_classes=CLASSES,
                        num_channels=FEATURE, dropout_rate=0.0, device="cpu",
                        remat=True)
    net.load_state_dict(case["weights"], strict=True)
    net.train()
    logits = net(case["images"])
    value, _ = segmentation_loss(logits, case["labels"],
                                 name="mixed_sorensen", num_classes=CLASSES,
                                 alpha=1.0)
    value.backward()
    return (logits.detach(), float(value.detach()),
            {k: p.grad for k, p in net.named_parameters()})


def _worst_grad_gap(grads, ref_grads):
    """The largest of each leaf's max |diff| over its reference's largest
    entry, and that leaf."""
    gaps = {k: float((grads[k] - r).abs().max()
                     / r.abs().max().clamp_min(1e-30))
            for k, r in ref_grads.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def test_forward_loss_and_gradients_match_reference(case):
    logits, value, grads = _port(case)
    scale = float(case["logits"].abs().max())
    assert float((logits - case["logits"]).abs().max()) <= LOGIT_RTOL * scale
    assert abs(value - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    assert set(grads) == set(case["grads"])
    gap, leaf = _worst_grad_gap(grads, case["grads"])
    assert gap <= GRAD_RTOL, f"{leaf}: {gap:.3g}"


def _own_index_forward(self, windows, regions):
    """A clamped window indexed by its own relative-position index (the
    planted fault; MONAI slices the configured window's)."""
    side = round(windows.shape[1] ** (1 / 3))
    index = su.relative_position_index((side,) * 3)
    qkv = su.linear(windows, self.qkv)
    out = wa.window_attention(qkv, self.heads,
                              self.relative_position_bias_table, index,
                              regions, self.scale)
    return su.linear(out, self.proj)


@pytest.mark.parametrize("fault", ["no_shift_mask", "transposed_index",
                                   "clamped_own_index"])
def test_planted_faults_are_caught(case, fault, monkeypatch):
    if fault == "no_shift_mask":
        monkeypatch.setattr(su, "region_ids", lambda *a, **k: None)
    elif fault == "transposed_index":
        index = su.relative_position_index
        monkeypatch.setattr(su, "relative_position_index",
                            lambda w: index(w).t().contiguous())
    else:
        monkeypatch.setattr(su.WindowAttention, "forward",
                            _own_index_forward)
    _, _, grads = _port(case)
    gap, leaf = _worst_grad_gap(grads, case["grads"])
    assert gap > FAULT_FACTOR * GRAD_RTOL, f"{fault} not caught: {leaf} {gap}"


def test_plain_attention_matches_reference_attention():
    """The plain version (the CPU's route of ``ops/window_attention.py``)
    against the reference's explicit attention, shifted (the mask from
    ``region_ids`` against the reference's ``compute_mask``) and not, with
    the bias table's gradient: float32, the same operations, within 1e-5
    of the largest entry."""
    g = torch.Generator().manual_seed(0)
    heads, d, grid, ws, ss = 2, 16, (14, 14, 7), (7, 7, 7), (3, 3, 0)
    nw = math.prod(n // k for n, k in zip(grid, ws))
    n = math.prod(ws)
    regions = su.region_ids(grid, ws, ss, "cpu")
    mask = ref.shift_mask(grid, ws, ss, "cpu")
    assert torch.equal(wa.region_mask(regions), mask)
    index = su.relative_position_index((7, 7, 7))[:n, :n]
    assert torch.equal(index, ref.bias_index((7, 7, 7))[:n, :n])
    for shifted in (True, False):
        qkv = torch.randn(2 * nw, n, 3 * heads * d, generator=g)
        table = 0.05 * torch.randn(13 ** 3, heads, generator=g)
        cot = torch.randn(2 * nw, n, heads * d, generator=g)
        q1 = qkv.clone().requires_grad_(True)
        t1 = table.clone().requires_grad_(True)
        out = wa.window_attention(q1, heads, t1, index,
                                  regions if shifted else None)
        (out * cot).sum().backward()
        q2 = qkv.clone().requires_grad_(True)
        t2 = table.clone().requires_grad_(True)
        ctx = base.Ctx({"b.attn.relative_position_bias_table": t2}, "train",
                       base.rounding("float32"))
        m = mask.repeat(2, 1, 1) if shifted else None
        want = ref._attend(ctx, "b.", q2, heads, index, m)
        (want * cot).sum().backward()
        for got, exp in ((out.detach(), want.detach()), (q1.grad, q2.grad),
                         (t1.grad, t2.grad)):
            err = float((got - exp).abs().max())
            assert err <= 1e-5 * float(exp.abs().max()), err


@pytest.mark.parametrize("case", [(2, (14, 14, 7), (7, 7, 7), (3, 3, 0), 2),
                                  (2, (6, 6, 6), (6, 6, 6), (0, 0, 0), 3)])
def test_library_route_matches_plain_attention(case):
    """``tools/wattn_bench.py``'s library route (SDPA, the mask broadcast
    over the batch, shifted and not) computes the plain version's attention
    and the bias table's gradient: float32 on the CPU, within 1e-5 of the
    largest entry."""
    from vnet_tpu_torch.tools import wattn_bench as wb

    g = torch.Generator().manual_seed(1)
    qkv, table, index, regions, cot = wb.inputs(case, g, "cpu")
    heads = case[4]
    got, want = [], []
    for fn, out in ((wb.library_attention, got),
                    (wa.window_attention_plain, want)):
        q = qkv.float().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        y = fn(q, heads, t, index, regions)
        y.backward(cot.float())
        out += [y.detach(), q.grad, t.grad]
    for a, b in zip(got, want):
        assert wb._rel(a, b) <= 1e-5


def test_shipped_config_builds_the_published_network():
    cfg = load_config(os.path.join(ROOT, "configs", "torch",
                                   "config_swin_unetr_btcv.json"))
    t = cfg.train
    assert (t.network.name, t.network.num_channel, t.num_classes,
            t.patch_shape, t.precision) == ("SwinUNETR", 48, 14,
                                              (96, 96, 96), "bfloat16")
    assert (su.DEPTHS, su.HEADS, su.WINDOW, su.PATCH) == (
        (2, 2, 2, 2), (3, 6, 12, 24), (7, 7, 7), 2)
    assert (ref.DEPTHS, ref.HEADS, ref.WINDOW, ref.PATCH) == (
        su.DEPTHS, su.HEADS, su.WINDOW, su.PATCH)
    frozen = json.load(open(os.path.join(
        ROOT, "portbench", "configs", "swin_unetr_btcv.json")))["settings"]
    assert parse_config(frozen).train.network == t.network
    net = build_network("SwinUNETR", num_classes=t.num_classes,
                        num_channels=t.network.num_channel, dropout_rate=0.0,
                        device="cpu", remat=t.network.remat,
                        num_levels=t.network.num_levels)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == dict(ref.named_shapes(
        {"in_channels": 1, "num_channel": 48, "num_classes": 14}))
    assert sum(math.prod(s) for s in shapes.values()) == 62_187_296
    assert "swinViT.layers1.0.blocks.0.attn.relative_position_index" \
        not in shapes
    with pytest.raises(ValueError, match="divisible by 32"):
        net(torch.zeros(1, 48, 48, 48, 1))


def _write_config(tmp, **setting):
    crop = {"output_size": list(PATCH)}
    norm = {"name": "ManualNormalization",
            "variables": {"windowMin": 0, "windowMax": 200}}
    pipeline = {"preprocess": {
        "train": {"3D": [norm, {"name": "Padding", "variables": crop},
                         {"name": "RandomCrop",
                          "variables": dict(crop, drop_ratio=0.5,
                                            min_pixel=1)}]},
        "evaluate": {"3D": [norm, {"name": "Padding", "variables": crop}]}}}
    import yaml
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": str(tmp / "training"),
                     "TestingDataDirectory": str(tmp / "training")},
            "Restore": False, "SegmentationClasses": [0, 1],
            "LogDir": str(tmp / "log"), "CheckpointDir": str(tmp / "ckpt"),
            "BatchSize": 2, "PatchShape": list(PATCH), "Testing": False,
            "MaxIterations": 2, "LogInterval": 1, "LoaderWorkers": 0,
            "Networks": {"Name": "SwinUNETR", "Dropout": 0.0,
                         "NumChannel": FEATURE, "NumLevels": 4,
                         "Remat": True},
            "Loss": {"Name": "mixed_sorensen", "Alpha": 1.0},
            "Optimizer": {"Name": "Adam", "InitialLearningRate": 1e-4},
            "Pipeline": str(tmp / "pipeline.yaml"), "Precision": "float32",
            **setting},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp / "evaluate")},
            "CheckpointPath": str(tmp / "ckpt"), "Stride": [16, 16, 16],
            "BatchSize": 2, "GaussianBlend": True,
            "Pipeline": str(tmp / "pipeline.yaml")}}
    path = tmp / "config.json"
    path.write_text(json.dumps(tree))
    return str(path)


def test_cli_trains_and_evaluates(tmp_path):
    """``python -m vnet_tpu_torch -p train`` then ``-p evaluate`` with a
    SwinUNETR config: finite losses, a checkpoint whose sidecar names the
    network, an evaluation through the sliding window."""
    make_dataset_dir(str(tmp_path), "training", num_cases=2,
                     rng=np.random.default_rng(1), shape=(36, 34, 32))
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1,
                     rng=np.random.default_rng(2), shape=(40, 32, 32))
    cfg = _write_config(tmp_path)
    state = main(["-p", "train", "--config_json", cfg, "--device", "cpu"])
    assert state.step == 2
    with open(tmp_path / "log" / "train" / "scalars.jsonl") as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert checkpoints.restore_latest_state(str(tmp_path / "ckpt"))[
        "step"] == 2
    with open(tmp_path / "ckpt" / "network_config.json") as f:
        networks = json.load(f)["Networks"]
    assert (networks["Name"], networks["NumChannel"]) == ("SwinUNETR",
                                                          FEATURE)
    results = main(["-p", "evaluate", "--config_json", cfg,
                    "--device", "cpu"])
    assert len(results) == 1 and os.path.exists(results[0])


def test_space_parallel_raises(tmp_path):
    """A mesh of two slabs a row (as ``Mesh.SpaceParallel: 2`` builds on two
    ranks) is refused: the windows and instance norms cross the slabs."""
    import dataclasses

    from vnet_tpu_torch.parallel import make_mesh
    from vnet_tpu_torch.train import Trainer

    cfg = load_config(_write_config(tmp_path))
    mesh = dataclasses.replace(make_mesh(device="cpu"), space=2)
    with pytest.raises(NotImplementedError, match="SwinUNETR"):
        Trainer(cfg, device="cpu", log=False, mesh=mesh)
