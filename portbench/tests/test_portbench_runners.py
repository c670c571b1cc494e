"""The runners end to end at a tiny size on the CPU, against the plain
reference: a sound run is correct, every fault the check must catch and
the control are not, and the reference's names, masks and layouts are the
program's."""

from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import spec
from portbench.reference import attention3d_mm, vnet3d_liver
from portbench.runners import train as train_runner
from portbench.tests.conftest import ATTENTION, EVAL, TRAIN, tiny
from portbench.yardstick import compare


def _run(cell, seconds=0.5, trace=False):
    return cell.runner().run(cell, 2 ** 31 + 12345, seconds, trace,
                             time.perf_counter(), "cpu")


def _verdict(cell, out):
    return compare.verdict(out.numbers, cell.limits)[0]


@pytest.mark.parametrize("name,ref", [(TRAIN, vnet3d_liver),
                                      (ATTENTION, attention3d_mm)])
def test_reference_names_and_shapes_are_the_programs(name, ref):
    from vnet_tpu_torch.config import parse_config
    from vnet_tpu_torch.train.trainer import Trainer
    cell = spec.load_cell(name)
    t = Trainer(parse_config(cell.tree), device="meta", log=False)
    ours = dict(ref.named_shapes(cell.settings["network"]))
    theirs = {k: tuple(v.shape) for k, v in t.network.state_dict().items()}
    assert ours == theirs


def test_reference_masks_are_the_programs_in_the_packed_layout(tiny_train):
    from vnet_tpu_torch.models.layers import Dropout
    from vnet_tpu_torch.ops.s2d import depth_to_space
    cell = tiny_train
    s = cell.settings
    trainer, _ = train_runner.build(cell, 5, "cpu")
    batch = train_runner.pool(cell, 5, "cpu")[0]
    seen = {}
    for n, m in trainer.network.named_modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(lambda mod, i, o, n=n: seen.__setitem__(
                n, (o != 0) | (i[0] == 0)))
    trainer.network.train()
    with torch.no_grad():
        trainer.network(torch.from_numpy(batch["images"]), dropout_seed=77)
    shapes = vnet3d_liver.layer_shapes(s["network"], s["batch"], s["patch"])
    layers = vnet3d_liver.dropout_layers(s["network"])
    masks = vnet3d_liver.masks(layers, shapes, 77, s["network"]["dropout"],
                               "cpu")
    assert sorted(seen) == sorted(layers)
    for name in layers:
        factors = shapes[name][1]
        got = seen[name]
        if factors is not None:
            got = depth_to_space(got.to(torch.uint8), factors=factors).bool()
        assert torch.equal(got, masks[name]), name


@pytest.mark.parametrize("fixture", ["tiny_train", "tiny_attention"])
def test_train_runner_is_correct_against_the_reference(fixture, request):
    cell = request.getfixturevalue(fixture)
    out = _run(cell)
    assert _verdict(cell, out), out.numbers
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.metrics) == {"train_patches_per_s", "setup_s",
                                "peak_mem_gib"}
    assert out.metrics["train_patches_per_s"] > 0


def test_eval_runner_is_correct_against_the_reference(tiny_eval):
    out = _run(tiny_eval)
    assert _verdict(tiny_eval, out), out.numbers
    assert out.attempted >= 3
    assert set(out.metrics) == {"eval_mvox_per_s", "eval_volume_p95_s",
                                "setup_s", "peak_mem_gib"}


def test_traced_train_run_counts_its_work(tiny_train):
    out = _run(tiny_train, trace=True)
    r = out.reading
    assert r is not None and r.steps == out.attempted
    assert r.spans["portbench.train_step"]
    assert r.work["dropout_launches"] > 0 and r.work["dropout_bytes"] > 0
    assert r.work["flops"] > 0
    bench = spec.benchmark()
    for m in spec.metrics_of(bench, TRAIN)["per_layer"]:
        spec.metric_reader(m["name"]).read(r)  # none raises


# ---------------------------------------------------------------- faults
@pytest.mark.parametrize("moments_kept", [False, True])
@pytest.mark.parametrize("fixture", ["tiny_train", "tiny_attention"])
def test_fault_state_left_unchanged_is_caught(fixture, moments_kept, request,
                                              monkeypatch):
    """The weights stay where they were: Adam's step does nothing, or it
    fills its moments but the new weights never reach the network, which
    only the change can see."""
    cell = request.getfixturevalue(fixture)
    real = torch.optim.Adam.step

    def lost(self, *a, **k):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        real(self, *a, **k)
        with torch.no_grad():
            for p, old in zip(params, kept):
                p.copy_(old)

    monkeypatch.setattr(torch.optim.Adam, "step", lost if moments_kept
                        else lambda self, *a, **k: None)
    out = _run(cell)
    if moments_kept:
        assert out.numbers["grad_median_gap"] < cell.limits["grad_median_gap"]
    assert out.numbers["change_gap"] >= 0.99
    assert out.numbers["change_median_gap"] >= 0.9
    assert not _verdict(cell, out)


@pytest.mark.parametrize("fixture", ["tiny_train", "tiny_attention"])
def test_fault_half_batch_is_caught(fixture, request, monkeypatch):
    from vnet_tpu_torch.train.trainer import Trainer
    cell = request.getfixturevalue(fixture)
    real = Trainer.train_step

    def half(self, state, images, labels, seed, distance_maps=None):
        n = images.shape[0] // 2
        return real(self, state, images[:n], labels[:n], seed,
                    None if distance_maps is None else distance_maps[:n])

    monkeypatch.setattr(Trainer, "train_step", half)
    assert not _verdict(cell, _run(cell))


def test_fault_half_of_each_eval_batch_is_caught(tiny_eval, monkeypatch):
    from vnet_tpu_torch.infer import sliding_window
    real = sliding_window.blend_accumulate_patches

    def half(acc, contrib, starts):
        n = math.ceil(contrib.shape[0] / 2)
        return real(acc, contrib[:n].contiguous(), starts[:n])

    monkeypatch.setattr(sliding_window, "blend_accumulate_patches", half)
    assert not _verdict(tiny_eval, _run(tiny_eval))


def test_fault_altered_answer_is_caught(tiny_eval, monkeypatch):
    """The engine's answer for a volume, its class sums, altered where it
    is produced (two classes swapped)."""
    from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference
    real = SlidingWindowInference.__call__

    def altered(self, volume):
        acc, weight = real(self, volume)
        return acc[..., [1, 0] + list(range(2, acc.shape[-1]))], weight

    monkeypatch.setattr(SlidingWindowInference, "__call__", altered)
    assert not _verdict(tiny_eval, _run(tiny_eval))


# --------------------------------------------------------------- control
@pytest.mark.parametrize("fixture", ["tiny_train", "tiny_eval",
                                     "tiny_attention"])
def test_control_fails_and_the_program_passes(fixture, request):
    """The reference in fp8 in the program's place reads as not correct;
    the float32 program, read the same way, as correct."""
    cell = request.getfixturevalue(fixture)
    r = cell.runner().readings(cell, 7, "cpu", faults=("control",))
    assert compare.verdict(r["program"], cell.limits)[0], r
    assert not compare.verdict(r["control"], cell.limits)[0], r


@pytest.mark.parametrize("fixture", ["tiny_train", "tiny_attention"])
def test_half_batch_reading_of_the_reference(fixture, request):
    cell = request.getfixturevalue(fixture)
    r = train_runner.readings(cell, 7, "cpu", faults=("half_batch",))
    assert not compare.verdict(r["half_batch"], cell.limits)[0], r


def test_tiny_cells_share_the_harness_limits():
    for name in (TRAIN, EVAL, ATTENTION):
        assert tiny(name, [16, 16, 8], 2).limits == spec.load_cell(
            name).limits
