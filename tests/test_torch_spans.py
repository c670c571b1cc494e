"""The port's phase spans (``profiler.span``) on the CPU: which spans a
train step, a ``Remat`` recompute and an engine call open, how they nest,
and that with no profiler running a span is a null context that builds no
``record_function``.

Tiny networks (4 channels, 2 levels) in float32; the profiler records the
host alone, so each span's interval is its ``record_function`` event's.
"""

import contextlib
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vnet_tpu_torch import profiler
from vnet_tpu_torch.config import parse_config
from vnet_tpu_torch.infer.sliding_window import (SlidingWindowInference,
                                                 build_patch_grid)
from vnet_tpu_torch.models import layers
from vnet_tpu_torch.train.trainer import Trainer

PATCH, BATCH = (16, 16, 8), 2


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _trainer(remat=False, attention=False):
    net = {"Name": "VNet", "Dropout": 0.1, "NumChannel": 4, "NumLevels": 2,
           "NumConvolutions": [1, 2], "BottomConvolutions": 1,
           "Norm": "batch", "Remat": remat}
    images = ["image.nii"]
    if attention:
        net.update(Attention=True, AttentionChannels=4, AttentionBlocks=1)
        images = ["t1.nii", "t2.nii"]
    tree = {"TrainingSetting": {
        "Data": {"ImageFilenames": images, "LabelFilename": "label.nii"},
        "SegmentationClasses": [0, 1], "BatchSize": BATCH,
        "PatchShape": list(PATCH), "Networks": net,
        "Loss": {"Name": "weighted_sorensen", "Weights": [0.1, 1.0]},
        "Optimizer": {"Name": "Adam", "InitialLearningRate": 1e-3},
        "Precision": "float32", "Seed": 3}}
    return Trainer(parse_config(tree), device="cpu", log=False)


def _batch(trainer):
    rng = np.random.default_rng(5)
    channels = 2 if trainer.is_attention else 1
    images = rng.normal(size=(BATCH,) + PATCH + (channels,)).astype(
        np.float32)
    labels = (rng.random((BATCH,) + PATCH) > 0.5).astype(np.int32)
    return images, labels


def _spans(prof):
    """``{name: [(start, end), ...]}`` of the trace's ``vnet.`` spans."""
    out = {}
    for e in prof.events():
        if e.name.startswith("vnet."):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("remat,attention", [
    (False, False), (True, False), (True, True)],
    ids=["plain", "remat", "attention_remat"])
def test_train_step_spans(remat, attention, monkeypatch):
    """One step: one ``vnet.train.step`` holding one forward and one
    backward, and with ``Remat`` one recompute per recomputed block, each
    inside the backward."""
    trainer = _trainer(remat, attention)
    state = trainer.init_state()
    images, labels = _batch(trainer)
    blocks = []
    checkpoint = layers.checkpoint

    def counted(*args, **kwargs):
        blocks.append(args[0])
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(layers, "checkpoint", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, images, labels, 7)
    spans = _spans(prof)
    (step,) = spans["vnet.train.step"]
    (forward,) = spans["vnet.train.forward"]
    (backward,) = spans["vnet.train.backward"]
    assert _inside(forward, step) and _inside(backward, step)
    assert forward[1] <= backward[0]
    recomputes = spans.get("vnet.remat.recompute", [])
    assert len(recomputes) == len(blocks)
    assert (len(blocks) > 0) == remat
    assert all(_inside(r, backward) for r in recomputes)
    assert set(spans) <= {"vnet.train.step", "vnet.train.forward",
                          "vnet.train.backward", "vnet.remat.recompute"}


@pytest.mark.parametrize("shape,batch", [((20, 18, 13, 1), 3),
                                         ((16, 16, 8, 1), 4)])
def test_engine_spans(shape, batch):
    """An engine call: one ``vnet.engine.volume`` holding one
    ``vnet.engine.forward`` per batch of the padded grid."""
    patch, stride = (8, 8, 4), (6, 6, 3)
    engine = SlidingWindowInference(
        lambda p: p.repeat(1, 1, 1, 1, 2), patch, stride, batch, 2,
        gaussian_blend=True, blend_impl="xla", device="cpu")
    volume = np.random.default_rng(1).random(shape).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine(volume)
    spans = _spans(prof)
    (whole,) = spans["vnet.engine.volume"]
    batches = math.ceil(len(build_patch_grid(shape[:3], patch, stride))
                        / batch)
    assert len(spans["vnet.engine.forward"]) == batches
    assert all(_inside(f, whole) for f in spans["vnet.engine.forward"])
    assert set(spans) == {"vnet.engine.volume", "vnet.engine.forward"}


def test_span_without_a_profiler_builds_nothing(monkeypatch):
    """With no profiler running a span is a null context and no
    ``record_function`` is built, through a train step with ``Remat`` and
    an engine call alike; under a profiler the same call builds one."""
    built = []
    record_function = torch.profiler.record_function

    def counting(name, *args):
        built.append(name)
        return record_function(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert isinstance(profiler.span("vnet.train.step"),
                      contextlib.nullcontext)
    trainer = _trainer(remat=True)
    trainer.train_step(trainer.init_state(), *_batch(trainer), 7)
    SlidingWindowInference(lambda p: p.repeat(1, 1, 1, 1, 2), (8, 8, 4),
                           (8, 8, 4), 2, 2, blend_impl="xla",
                           device="cpu")(np.zeros((8, 8, 8, 1), np.float32))
    assert built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("vnet.train.step"):
            pass
    assert built == ["vnet.train.step"]
