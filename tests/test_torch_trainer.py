"""The slice as a whole: the port's train step against the JAX package's
``make_train_step``, then the port's training CLI end to end on the CPU.

Same numpy batch, same converted variables, dropout 0, float32, 4 channels,
2 levels, 16^3 patches, and the 2D network at 32^2 patches. The port runs
its ``DwImpl: pallas`` path (the plain weight gradient on the CPU in 3D,
autograd's at rank 2) and direct convolutions; JAX runs its direct
convolutions with XLA's gradients, jitted as its trainer runs them. Sums run in another order on each
side, so the loss agrees to ``rtol = 1e-5``; gradients, running averages
and parameters agree to ``rtol = 1e-3`` and ``atol = 1e-4`` of the largest
entry of their kind (conv biases ahead of a batch norm have a gradient that
is zero up to rounding, so a per-tensor relative bound would measure noise).
Parameters are compared after SGD steps only: Adam's first update is about
``lr * sign(g)``, which flips for entries near 0 under any change of
summation order (``test_torch_optim.py`` holds Adam on identical
gradients).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fixtures import make_dataset_dir
from pathlib import Path
from vnet_tpu.config import LossConfig as JaxLossConfig
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.ops.losses import segmentation_loss as jax_segmentation_loss
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu.train.trainer import Trainer as JaxTrainer
from vnet_tpu.train.trainer import make_train_step as jax_make_train_step
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.config import LossConfig, OptimizerConfig, load_config
from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.train import (TrainState, Trainer, checkpoints,
                                  make_train_step)
from vnet_tpu_torch.train.events import event_files, read_events
from vnet_tpu_torch.train.optim import build_optimizer

from torch_parity import random_variables

SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1,
             dropout_rate=0.0, norm="batch")
LOSS = dict(name="weighted_sorensen", weights=(0.01, 0.1, 1.0), alpha=1.0)
LR = 0.05
RTOL, ATOL_FRACTION = 1e-3, 1e-4


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, ref, what):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys(), what
    atol = ATOL_FRACTION * max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {key}")


def _pair(spatial):
    """JAX and port networks with the same variables, one batch."""
    rng = np.random.default_rng(21)
    images = rng.normal(50.0, 20.0, size=(2,) + spatial + (1,)).astype(
        np.float32)
    labels = rng.integers(0, 3, size=(2,) + spatial).astype(np.int32)
    jnet = jax_build_network("VNet", conv_impl="direct", **SMALL)
    variables = random_variables(jnet, rng, jnp.asarray(images), train=True)
    return jnet, variables, images, labels


@pytest.fixture(scope="module")
def pair():
    return _pair((16, 16, 16))


@pytest.fixture(scope="module")
def pair2d():
    return _pair((32, 32))


def _jax_steps(pair, n):
    jnet, variables, images, labels = pair
    tx = optax.sgd(LR)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    step = jax.jit(jax_make_train_step(jnet, tx, JaxLossConfig(**LOSS), 3,
                                       False))
    losses = []
    for _ in range(n):
        state, loss, _, _ = step(state, jnp.asarray(images),
                                 jnp.asarray(labels), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return state, losses


def _port_steps(pair, n):
    _, variables, images, labels = pair
    net = build_network("VNet", device="cpu", dw_impl="pallas",
                        dropout_impl="pallas", spatial_rank=images.ndim - 2,
                        **SMALL)
    net.load_state_dict(flax_to_state_dict(variables))
    opt, schedule = build_optimizer(
        OptimizerConfig(name="SGD", initial_learning_rate=LR,
                        decay_factor=1.0), net.parameters())
    step = make_train_step(LossConfig(**LOSS), 3, schedule)
    state = TrainState(net, opt)
    outs = [step(state, torch.from_numpy(images), torch.from_numpy(labels),
                 dropout_seed=i) for i in range(n)]
    return state, outs


def test_first_step_loss_gradients_batch_stats(pair):
    _check_first_step(pair)


def test_2d_first_step_loss_gradients_batch_stats(pair2d):
    """The 2D step: the rank-2 network, ``DwImpl: pallas`` routed to
    autograd's weight gradient at rank 2, as JAX routes it."""
    _check_first_step(pair2d)


def test_2d_params_after_three_sgd_steps(pair2d):
    test_params_after_three_sgd_steps(pair2d)


def _check_first_step(pair):
    jnet, variables, images, labels = pair

    def loss_fn(params):
        out, mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        loss, _ = jax_segmentation_loss(out, jnp.asarray(labels),
                                    num_classes=3, **LOSS)
        return loss, mutated["batch_stats"]

    # jitted, as the JAX trainer runs it (op-by-op dispatch of the 2D
    # convolutions' gradients on the CPU is off by 1e-3 of the largest)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    jstate, jlosses = _jax_steps(pair, 1)
    assert jlosses[0] == pytest.approx(float(jloss), rel=1e-6)

    state, outs = _port_steps(pair, 1)
    assert state.step == 1
    np.testing.assert_allclose(outs[0].loss.item(), float(jloss), rtol=1e-5)
    grads = grads_to_flax({k: p.grad for k, p in
                           state.network.named_parameters()})
    _assert_trees_close(grads, jax.device_get(jgrads), "gradient")
    stats = {k: v for k, v in state.network.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    _assert_trees_close(state_dict_to_flax(stats)["batch_stats"],
                        jax.device_get(jstate.batch_stats), "batch_stats")


def test_params_after_three_sgd_steps(pair):
    jstate, jlosses = _jax_steps(pair, 3)
    state, outs = _port_steps(pair, 3)
    np.testing.assert_allclose([o.loss.item() for o in outs], jlosses,
                               rtol=1e-4)
    params = state_dict_to_flax({k: p for k, p in
                                 state.network.named_parameters()})["params"]
    _assert_trees_close(params, jax.device_get(jstate.params), "params")


# ---------------------------------------------------------------------------
# the training CLI on the CPU

PATCH = (16, 16, 16)


AUGMENT = [{"name": "RandomFlip", "variables": {"axes": [True, False, True]}},
           {"name": "RandomNoise", "variables": {"sigma": 2.0}}]


def _write_config(tmp, restore=False, max_iterations=2, batch=2, scan=1,
                  testing=False, augment=False, networks=None, **setting):
    pipeline = {"preprocess": {
        "train": {"3D": [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 0, "windowMax": 200}},
            {"name": "Padding", "variables": {"output_size": list(PATCH)}},
            {"name": "RandomCrop",
             "variables": {"output_size": list(PATCH), "drop_ratio": 0.5,
                           "min_pixel": 1}}] + (AUGMENT if augment else [])},
        "evaluate": {"3D": [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 0, "windowMax": 200}},
            {"name": "Padding", "variables": {"output_size": list(PATCH)}}]}}}
    pipeline["preprocess"]["test"] = {
        "3D": pipeline["preprocess"]["train"]["3D"][:3]}
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": str(tmp / "training"),
                     "TestingDataDirectory": str(tmp / "training")},
            "Restore": restore, "SegmentationClasses": [0, 1],
            "LogDir": str(tmp / "log"), "CheckpointDir": str(tmp / "ckpt"),
            "BatchSize": batch, "PatchShape": list(PATCH),
            "Testing": testing, "TestStep": 1, "MaxIterations": max_iterations,
            "LogInterval": 1, "ScanSteps": scan, "LoaderWorkers": 0,
            "Networks": {"Name": "VNet", "Dropout": 0.1, "NumChannel": 4,
                         "NumLevels": 2, "NumConvolutions": [1, 2],
                         "BottomConvolutions": 1, "Norm": "batch",
                         "DropoutImpl": "pallas", "DwImpl": "pallas"},
            "Loss": {"Name": "weighted_sorensen", "Weights": [0.1, 1.0]},
            "Optimizer": {"Name": "Adam", "InitialLearningRate": 1e-3},
            "Pipeline": str(tmp / "pipeline.yaml"), "Precision": "float32",
            **setting},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp / "evaluate")},
            "CheckpointPath": str(tmp / "ckpt"), "Stride": list(PATCH),
            "BatchSize": 2, "Pipeline": str(tmp / "pipeline.yaml")}}
    tree["TrainingSetting"]["Networks"].update(networks or {})
    path = tmp / "config.json"
    path.write_text(json.dumps(tree))
    return str(path)


@pytest.fixture
def data_dir(tmp_path):
    make_dataset_dir(str(tmp_path), "training", num_cases=2,
                     rng=np.random.default_rng(1))
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1,
                     rng=np.random.default_rng(2))
    return tmp_path


def _scalars(tmp, tag):
    with open(tmp / "log" / tag / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_trains_checkpoints_resumes_and_evaluates(data_dir):
    tmp = data_dir
    state = main(["-p", "train", "--config_json", _write_config(tmp),
                  "--device", "cpu"])
    assert state.step == 2 and state.epoch >= 1
    saved = checkpoints.restore_latest_state(str(tmp / "ckpt"))
    assert saved["step"] == 2 and saved["optimizer"]["state"]
    for k, v in state.network.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    scalars = _scalars(tmp, "train")
    tags = {s["tag"] for s in scalars}
    assert {"loss/0.total_loss", "learning_rate", "metrics/accuracy",
            "metrics/dice_1", "metrics/sensitivity_1"} <= tags
    assert all(np.isfinite(s["value"]) for s in scalars)

    resumed = main(["-p", "train", "--config_json",
                    _write_config(tmp, restore=True, max_iterations=4),
                    "--device", "cpu"])
    assert resumed.step == 4 and resumed.epoch >= state.epoch
    assert checkpoints.latest_step(str(tmp / "ckpt")) == 4

    results = main(["-p", "evaluate", "--config_json",
                    _write_config(tmp, restore=True), "--device", "cpu"])
    assert len(results) == 1 and os.path.exists(results[0])


def test_restore_false_wipes_and_scan_steps_run(data_dir):
    tmp = data_dir
    (tmp / "ckpt").mkdir()
    checkpoints.save(str(tmp / "ckpt"), {"w": torch.zeros(1)}, 99)
    state = main(["-p", "train", "--config_json",
                  _write_config(tmp, batch=1, scan=2, max_iterations=6,
                                testing=True), "--device", "cpu"])
    assert state.step == 6  # three 2-step blocks; the first two are warm-up
    assert checkpoints.latest_step(str(tmp / "ckpt")) == 6
    assert _scalars(tmp, "test")
    assert any(s["tag"] == "perf/step_time_s" for s in _scalars(tmp, "train"))


def test_a_run_repeats_itself_with_one_loader_worker(data_dir):
    """Two runs of one config (random crops of 24x24x16 cases into 16^3
    patches, ``LoaderWorkers: 1``) end with the same parameters bitwise:
    the trainer seeds the host transforms' shared generator from ``Seed``
    (left to the operating system, two runs drew other crops and trained
    apart from the first step)."""
    cfg = load_config(_write_config(data_dir, LoaderWorkers=1))
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, device="cpu", log=False)
        trainer.network.load_state_dict(runs[0][1] if runs else
                                        trainer.network.state_dict())
        start = {k: v.clone() for k, v in trainer.network.state_dict().items()}
        state = trainer.train()
        runs.append((state.network.state_dict(), start))
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k
    assert any(not torch.equal(v, runs[0][1][k])
               for k, v in runs[0][0].items())


def test_no_batches_raises(data_dir):
    cfg = load_config(_write_config(data_dir, batch=3))
    with pytest.raises(ValueError, match="no batches"):
        Trainer(cfg, device="cpu").train()


def test_trainer_defaults_to_cuda(data_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = load_config(_write_config(data_dir))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_network("VNet", num_classes=2)


def test_sidecar_equals_jax_for_the_shipped_config(tmp_path):
    """``network_config.json``, key for key and value for value, as the
    JAX trainer writes it for ``configs/config.json``."""
    path = str(Path(__file__).resolve().parent.parent / "configs"
               / "config.json")
    JaxTrainer(jax_load_config(path), log=False)._write_network_sidecar(
        str(tmp_path / "jax"))
    Trainer(load_config(path), device="cpu", log=False) \
        ._write_network_sidecar(str(tmp_path / "port"))
    jax_tree, port_tree = (json.loads((tmp_path / side / "network_config.json")
                                      .read_text())
                           for side in ("jax", "port"))
    assert port_tree == jax_tree
    assert {"PackedTargetLanes", "Remat", "Attention", "DwImpl"} <= set(
        port_tree["Networks"])


def test_cli_attention_trains_and_evaluates(data_dir):
    """``Attention: true`` through the CLI: the loader adds distance maps,
    the step logs the attention loss, the sidecar says so, and evaluation
    blends the refined logits; ``max_cases`` limits the cases written."""
    tmp = data_dir
    make_dataset_dir(str(tmp), "evaluate", num_cases=2,
                     rng=np.random.default_rng(4))
    cfg = _write_config(tmp, networks={"Attention": True})
    state = main(["-p", "train", "--config_json", cfg, "--device", "cpu"])
    assert state.step == 2
    assert type(state.network).__name__ == "AttentionGatedVNet"
    sidecar = json.loads((tmp / "ckpt" / "network_config.json").read_text())
    assert sidecar["Networks"]["Attention"] is True
    tags = {s["tag"] for s in _scalars(tmp, "train")}
    assert {"loss/attention_loss", "loss/0.total_loss"} <= tags
    assert "loss/total_loss" not in tags
    results = main(["-p", "evaluate", "--config_json", cfg, "--device",
                    "cpu"])
    assert len(results) == 2 and all(os.path.exists(r) for r in results)
    from vnet_tpu_torch.infer.evaluator import Evaluator
    from vnet_tpu_torch.io import read_image
    for r in results:
        os.remove(r)
    ev = Evaluator(load_config(cfg), device="cpu")
    assert ev.is_attention
    (one,) = ev.evaluate(max_cases=1)
    assert os.path.exists(one) and not os.path.exists(results[1])
    assert set(np.unique(read_image(one).data).tolist()) <= {0, 1}


def test_device_augment_image_log_and_trace(data_dir):
    """``DeviceAugment`` moves the flip and the noise into the step;
    ``ImageLog`` writes PNG images into the events files; ``--profile_dir``
    writes a Chrome trace; ``--devices 2`` raises before it starts a rank,
    since a batch of 1 does not split over two data-parallel ranks."""
    tmp = data_dir
    cfg = _write_config(tmp, augment=True, testing=True, batch=1,
                        DeviceAugment=True, ImageLog=True)
    trainer = Trainer(load_config(cfg), device="cpu")
    loader = trainer.build_loader(str(tmp / "training"), "train")
    names = [type(t).__name__ for t in loader.dataset.transforms]
    assert "RandomFlip" not in names and "RandomNoise" not in names
    assert trainer._device_aug == ((0, 2), 2.0)

    trace_dir = tmp / "trace"
    state = main(["-p", "train", "--config_json", cfg, "--device", "cpu",
                  "--profile_dir", str(trace_dir), "--gpu", "0",
                  "--devices", "1", "-v"])
    assert state.step == 2
    traces = list(trace_dir.glob("trace_*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    for tag in ("train", "test"):
        (path,) = event_files(str(tmp / "log" / tag))
        values = [v for e in read_events(path) for v in e["values"]]
        images = [v["image"] for v in values if "image" in v]
        assert images and all(im["encoded"].startswith(b"\x89PNG")
                              for im in images)
        scalars = {v["tag"] for v in values if "simple_value" in v}
        assert scalars == {s["tag"] for s in _scalars(tmp, tag)}
    with pytest.raises(ValueError, match="--devices 2: a batch of 1 does "
                                         "not split over 2"):
        main(["-p", "train", "--config_json", cfg, "--device", "cpu",
              "--devices", "2"])


def _write_config_2d(tmp, restore=False, max_iterations=2, **setting):
    """A 2D config: 16^2 training crops of slices with at least ``MinPixel``
    labelled pixels, 24^2 test crops, evaluation padded to 16^2."""
    norm = {"name": "ManualNormalization",
            "variables": {"windowMin": 0, "windowMax": 200}}

    def crop(size):
        return [norm, {"name": "Padding", "variables": {"output_size": size}},
                {"name": "RandomCrop", "variables": {"output_size": size}}]

    pipeline = {"preprocess": {
        "train": {"3D": None, "2D": crop([16, 16]) + [{"name": "RandomFlip"}]},
        "test": {"3D": None, "2D": crop([24, 24])},
        "evaluate": {"3D": None, "2D": crop([16, 16])[:2]}}}
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    path = _write_config(tmp, restore=restore, max_iterations=max_iterations,
                         testing=True, PatchShape=[16, 16], MinPixel=10,
                         DropRatio=0.1, CacheCases=2, DeviceAugment=True,
                         **setting)
    tree = json.loads(open(path).read())
    tree["TrainingSetting"]["Pipeline"] = str(tmp / "pipeline.yaml")
    tree["EvaluationSetting"]["Stride"] = [8, 8]
    path = tmp / "config2d.json"
    path.write_text(json.dumps(tree))
    # _write_config rewrote the 3D pipeline; put the 2D one back
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    return str(path)


def test_cli_2d_trains_checkpoints_resumes_and_evaluates(data_dir):
    """A 2D config through the CLI on the CPU: the slice loader (its test
    phase at 24^2 through the fully convolutional network), image logs of
    rank-2 batches, checkpoints, a resumed run, and slice-by-slice
    evaluation of the volume."""
    tmp = data_dir
    cfg = _write_config_2d(tmp, ImageLog=True)
    trainer = Trainer(load_config(cfg), device="cpu", log=False)
    assert trainer.network.spatial_rank == 2
    loader = trainer.build_loader(str(tmp / "training"), "train")
    assert type(loader.dataset).__name__ == "NiftiDataset2D"
    assert loader.dataset.min_pixel == 10 and loader.dataset.cache_cases == 2
    # DeviceAugment is 3D only: the 2D flip stays in the host chain
    assert "RandomFlip" in [type(t).__name__
                            for t in loader.dataset.transforms2D]
    assert trainer._device_aug is None

    state = main(["-p", "train", "--config_json", cfg, "--device", "cpu"])
    assert state.step == 2
    saved = checkpoints.restore_latest_state(str(tmp / "ckpt"))
    assert saved["step"] == 2
    assert saved["model"]["encoder_level_1.conv_1.weight"].shape == (
        4, 4, 5, 5)
    test = _scalars(tmp, "test")
    assert test and all(np.isfinite(s["value"]) for s in test)
    assert all(np.isfinite(s["value"]) for s in _scalars(tmp, "train"))
    assert "metrics/dice_1" in {s["tag"] for s in test}
    for tag in ("train", "test"):
        (path,) = event_files(str(tmp / "log" / tag))
        images = [v["image"] for e in read_events(path) for v in e["values"]
                  if "image" in v]
        assert images and all(im["encoded"].startswith(b"\x89PNG")
                              for im in images)
    sidecar = json.loads((tmp / "ckpt" / "network_config.json").read_text())
    assert sidecar["PatchShape"] == [16, 16]

    resumed = main(["-p", "train", "--config_json",
                    _write_config_2d(tmp, restore=True, max_iterations=3),
                    "--device", "cpu"])
    assert resumed.step == 3
    results = main(["-p", "evaluate", "--config_json", cfg, "--device",
                    "cpu"])
    assert len(results) == 1
    from vnet_tpu_torch.io import read_image
    label = read_image(results[0])
    src = read_image(os.path.join(os.path.dirname(results[0]), "image.nii"))
    assert label.GetSize() == src.GetSize() == (24, 24, 16)
    assert set(np.unique(label.data).tolist()) <= {0, 1}
