"""The slice as a whole: the port's train step against the JAX package's
``make_train_step``, then the port's training CLI end to end on the CPU.

Same numpy batch, same converted variables, dropout 0, float32, 4 channels,
2 levels, 16^3 patches. The port runs its ``DwImpl: pallas`` path (the
plain weight gradient on the CPU) and direct convolutions; JAX runs its
direct convolutions with XLA's gradients. Sums run in another order on each
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
from vnet_tpu.config import LossConfig as JaxLossConfig
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.ops.losses import segmentation_loss as jax_segmentation_loss
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu.train.trainer import make_train_step as jax_make_train_step
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.config import LossConfig, OptimizerConfig, load_config
from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.train import (TrainState, Trainer, checkpoints,
                                  make_train_step)
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


@pytest.fixture(scope="module")
def pair():
    """JAX and port networks with the same variables, one batch."""
    rng = np.random.default_rng(21)
    images = rng.normal(50.0, 20.0, size=(2, 16, 16, 16, 1)).astype(
        np.float32)
    labels = rng.integers(0, 3, size=(2, 16, 16, 16)).astype(np.int32)
    jnet = jax_build_network("VNet", conv_impl="direct", **SMALL)
    variables = random_variables(jnet, rng, jnp.asarray(images), train=True)
    return jnet, variables, images, labels


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
                        dropout_impl="pallas", **SMALL)
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
    jnet, variables, images, labels = pair

    def loss_fn(params):
        out, mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        loss, _ = jax_segmentation_loss(out, jnp.asarray(labels),
                                    num_classes=3, **LOSS)
        return loss, mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
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


def _write_config(tmp, restore=False, max_iterations=2, batch=2, scan=1,
                  testing=False):
    pipeline = {"preprocess": {
        "train": {"3D": [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 0, "windowMax": 200}},
            {"name": "Padding", "variables": {"output_size": list(PATCH)}},
            {"name": "RandomCrop",
             "variables": {"output_size": list(PATCH), "drop_ratio": 0.5,
                           "min_pixel": 1}}]},
        "evaluate": {"3D": [
            {"name": "ManualNormalization",
             "variables": {"windowMin": 0, "windowMax": 200}},
            {"name": "Padding", "variables": {"output_size": list(PATCH)}}]}}}
    pipeline["preprocess"]["test"] = pipeline["preprocess"]["train"]
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
            "Pipeline": str(tmp / "pipeline.yaml"), "Precision": "float32"},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp / "evaluate")},
            "CheckpointPath": str(tmp / "ckpt"), "Stride": list(PATCH),
            "BatchSize": 2, "Pipeline": str(tmp / "pipeline.yaml")}}
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
