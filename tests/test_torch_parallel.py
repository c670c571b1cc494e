"""Data parallelism of the port (``vnet_tpu_torch/parallel``) against JAX's
mesh and against the port's own single process, on the CPU.

Two ``gloo`` ranks run in spawned processes (``parallel.launch`` with a
``file://`` rendezvous under the test's directory, no TCP port); their
functions live in ``torch_parallel_ranks.py``, which imports no JAX. One
launch computes every R = 2 result of the parity tests while this process
computes JAX's on a 2-device ``data`` mesh (conftest's 8 CPU devices); a
second and third run the CLI at ``--devices 2``. Tiny sizes: 2 levels, 8
channels, 16^3 patches, float32.

Tolerances, with their reasons:

* The trainer step against JAX's: float32 sums in other orders (XLA's
  partitioned program against two processes and a gradient all-reduce),
  loss and metrics to ``rtol = 1e-4``, running averages within ``1e-4`` of
  the largest entry. Parameters after Adam: Adam's first update is exactly
  ``lr * a(g)``, ``a(g) = g / (|g| + eps)``, about ``lr * sign(g)``, so a
  gradient near 0 (a convolution bias ahead of a batch norm, whose
  gradient is rounding, or a weight's that happens to be small) moves its
  parameter by up to ``lr`` whatever its size or sign, and two summation
  orders may put it up to ``2 * lr`` apart. Each parameter is held to that
  amplification of the two runs' gradients, ``lr * |a(g1) - a(g2)|``, plus
  ``1e-4`` of the largest parameter; JAX's gradient is its Adam state's
  first moment over ``1 - b1``.
* The R = 2 step against the port's single process (dropout and device
  augmentation on): the same arithmetic but batch-norm moments and
  gradients summed in halves; the averaged gradients within ``1e-4`` of
  the largest, the rest as against JAX. The ranks' parameters and running
  averages are bitwise equal to each other.
* Batch norm at R = 2 against R = 1: float32 moments averaged over two
  halves, ``1e-5`` of the largest entry of each output.
* Metrics from global counts against JAX's on the joined batch: counts are
  exact in float32 here, the ratios to ``1e-6``.
* The sharded sliding window against JAX's: the same patches in the same
  batches through networks on two frameworks, ``atol = rtol = 1e-4``.
* Dropout masks, batch rows, loader rows: exact.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from fixtures import make_dataset_dir
from torch_parity import random_variables
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.infer.sliding_window import \
    SlidingWindowInference as JaxSlidingWindow
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.models import eval_apply as jax_eval_apply
from vnet_tpu.ops.metrics import batch_metrics as jax_batch_metrics
from vnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vnet_tpu.train.trainer import Trainer as JaxTrainer
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.convert import (_adam_leaf, flax_to_state_dict,
                                    grads_to_flax, state_dict_to_flax)
from vnet_tpu_torch.data.device_aug import random_noise
from vnet_tpu_torch.data.loader import BatchLoader
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.parallel import (Mesh, active_mesh, batch_rows,
                                     data_parallel, data_parallel_size,
                                     launch, make_mesh, make_multislice_mesh,
                                     pad_batch_to_multiple)
from vnet_tpu_torch.parallel import mesh as mesh_module
from vnet_tpu_torch.tools import dp_bench

PATCH = (16, 16, 16)
NET = dict(num_classes=2, num_channels=8, num_levels=2,
           num_convolutions=(1, 2), bottom_convolutions=1, dropout_rate=0.0)
WINDOW = dict(volume=(20, 18, 13, 1), patch=(8, 8, 8), stride=(5, 6, 4),
              batch=5)
LAUNCH_TIMEOUT = 240.0
# the Remat case: the network of NET with dropout on, packed at 16 lanes
REMAT_NET = dict(NET, dropout_rate=0.2, dropout_impl="pallas",
                 packed_target_lanes=16)
LR = 1e-3  # the configs' Adam learning rate at step 0
ADAM_EPS = 1e-8  # optax's and the port's


def _config(tmp, name, batch=4, dropout=0.0, max_iterations=1,
            restore=False):
    """A 2-level, 8-channel VNet config over ``tmp/training``; ``name``
    names its log and checkpoint directories."""
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
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": str(tmp / "training"),
                     "TestingDataDirectory": str(tmp / "training")},
            "Restore": restore, "SegmentationClasses": [0, 1],
            "LogDir": str(tmp / f"log_{name}"),
            "CheckpointDir": str(tmp / f"ckpt_{name}"),
            "BatchSize": batch, "PatchShape": list(PATCH), "Testing": False,
            "MaxIterations": max_iterations, "LogInterval": 1,
            "LoaderWorkers": 0,
            "Networks": {"Name": "VNet", "Dropout": dropout, "NumChannel": 8,
                         "NumLevels": 2, "NumConvolutions": [1, 2],
                         "BottomConvolutions": 1, "Norm": "batch",
                         "DropoutImpl": "pallas", "DwImpl": "pallas"},
            "Loss": {"Name": "weighted_sorensen", "Weights": [0.1, 1.0]},
            "Optimizer": {"Name": "Adam", "InitialLearningRate": LR},
            "Pipeline": str(tmp / "pipeline.yaml"), "Precision": "float32"},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp / "evaluate")},
            "CheckpointPath": str(tmp / f"ckpt_{name}"),
            "Stride": list(PATCH), "BatchSize": 2,
            "Pipeline": str(tmp / "pipeline.yaml")}}
    path = tmp / f"config_{name}{'_restore' if restore else ''}.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _launch(fn, tmp, *args):
    launch(fn, 2, backend="gloo", device="cpu",
           init_method=f"file://{tmp / 'rendezvous'}", args=args,
           timeout=LAUNCH_TIMEOUT)


def _close_to_largest(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    bound = rtol * max(np.abs(ref).max(), 1e-30)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _trees_close(got, ref, rtol, what):
    """Every leaf within ``rtol`` of the largest entry of ``ref``."""
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys(), what
    largest = max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        err = np.abs(got[key] - value).max()
        assert err <= rtol * largest, (
            f"{what} {key}: max |diff| {err:.3g} > {rtol * largest:.3g}")


def _adam_first(g):
    """Adam's first update direction (bias-corrected), in float64."""
    g = np.asarray(g, np.float64)
    return g / (np.abs(g) + ADAM_EPS)


def _params_after_adam_close(got, ref, grads_got, grads_ref, rtol):
    """Each parameter within Adam's amplification of the gradients'
    difference plus ``rtol`` of the largest (module docstring)."""
    got, ref = dict(_flat(got)), dict(_flat(ref))
    grads_got, grads_ref = dict(_flat(grads_got)), dict(_flat(grads_ref))
    assert got.keys() == ref.keys() == grads_got.keys() == grads_ref.keys()
    largest = max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        allow = LR * np.abs(_adam_first(grads_got[key])
                            - _adam_first(grads_ref[key]))
        excess = (np.abs(got[key] - value.astype(np.float64)) - allow).max()
        assert excess <= rtol * largest, (
            f"params {key}: |diff| exceeds Adam's amplification by "
            f"{excess:.3g} > {rtol * largest:.3g}")


# ----------------------------------------------------------------------
# the R = 2 launch and its references
# ----------------------------------------------------------------------
def _inputs(tmp):
    rng = np.random.default_rng(10)
    channels = 3
    bn = {}
    for case, c_in in (("unpacked", channels), ("packed", 2 * channels),
                       ("tiled", 1)):
        x = rng.normal(1.0, 2.0, (4, c_in, 5, 4, 3)).astype(np.float32)
        out_c = channels if case == "tiled" else c_in
        cot = rng.normal(size=(4, out_c, 5, 4, 3)).astype(np.float32)
        bn[case] = (x, cot)
    logits = rng.normal(size=(4, 6, 5, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (4, 6, 5, 4)).astype(np.int64)

    jtrainer = JaxTrainer(jax_load_config(_config(tmp, "step")),
                          mesh=jax_make_mesh(2, devices=jax.devices()[:2]),
                          log=False)
    images = rng.normal(50.0, 20.0, (4,) + PATCH + (1,)).astype(np.float32)
    variables = random_variables(jtrainer.network, np.random.default_rng(13),
                                 jnp.asarray(images), train=True)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtrainer.tx.init(variables["params"]))
    step_sd = flax_to_state_dict(variables)
    step_labels = rng.integers(0, 2, (4,) + PATCH).astype(np.int32)

    volume = rng.normal(size=WINDOW["volume"]).astype(np.float32)
    jnets, window_vars = {}, {}
    for norm in ("batch", "batch_stats"):
        jnets[norm] = jax_build_network("VNet", norm=norm, **NET)
        window_vars[norm] = random_variables(
            jnets[norm], np.random.default_rng(11),
            jnp.zeros((1,) + WINDOW["patch"] + (1,)), train=True)
    inputs = {
        "bn": bn, "bn_channels": channels, "bn_seed": 12,
        "dropout_x": rng.normal(size=(2, 5, 3, 3, 3)).astype(np.float32),
        "dropout_seed": 99, "metrics": (logits, labels),
        "step": {"config": _config(tmp, "step"), "state_dict": step_sd,
                 "images": images, "labels": step_labels},
        "augmented": {"config": _config(tmp, "aug", dropout=0.2),
                      "state_dict": step_sd, "images": images,
                      "labels": step_labels,
                      "device_augment": ((0, 1, 2), 5.0)},
        "window": {"net_kw": NET, "volume": volume,
                   "state_dicts": {k: flax_to_state_dict(v)
                                   for k, v in window_vars.items()},
                   "patch": WINDOW["patch"], "stride": WINDOW["stride"],
                   "batch": WINDOW["batch"]},
        "remat": {"net_kw": REMAT_NET, "state_dict": build_network(
                      "VNet", device="cpu", generator=torch.Generator()
                      .manual_seed(14), **REMAT_NET).state_dict(),
                  "images": images,
                  "cot": rng.normal(size=(4,) + PATCH + (2,)).astype(
                      np.float32)},
        "stack": rng.normal(size=(5, 20, 18, 2)).astype(np.float32),
        "stack_weights": rng.normal(size=(2, 3)).astype(np.float32),
        "writes_config": _config(tmp, "writes", batch=2),
        "resume_config": _config(tmp, "writes", batch=2, max_iterations=2,
                                 restore=True)}
    jax_side = dict(trainer=jtrainer, state=jstate, nets=jnets,
                    variables=window_vars)
    return inputs, jax_side


def _jax_results(inp, js):
    step = inp["step"]
    state, out = js["trainer"].train_step(
        js["state"], step["images"], step["labels"], jax.random.key(1))
    mesh = jax_make_mesh(2, devices=jax.devices()[:2])
    window = {}
    for norm, net in js["nets"].items():
        engine = JaxSlidingWindow(
            lambda v, p, net=net: jax_eval_apply(net, v, p),
            WINDOW["patch"], WINDOW["stride"], WINDOW["batch"],
            NET["num_classes"], gaussian_blend=True, mesh=mesh)
        acc, weight = engine(js["variables"][norm], inp["window"]["volume"])
        window[norm] = (np.asarray(acc), np.asarray(weight))
    logits, labels = inp["metrics"]
    metrics = jax_batch_metrics(jnp.asarray(logits), jnp.asarray(labels),
                                logits.shape[-1], compute_auc=True)
    first_moment = _adam_leaf(state.opt_state).mu
    return {"step": (float(out.loss),
                     {k: float(v) for k, v in out.metrics.items()},
                     jax.tree_util.tree_map(np.asarray, state.params),
                     jax.tree_util.tree_map(np.asarray, state.batch_stats),
                     jax.tree_util.tree_map(
                         lambda m: np.asarray(m) / np.float32(0.1),
                         first_moment)),
            "window": window,
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    make_dataset_dir(str(tmp), "training", num_cases=2,
                     rng=np.random.default_rng(1))
    inputs, jax_side = _inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    failure = []

    def run():
        try:
            _launch(ranks.parity_ranks, tmp, str(tmp))
        except Exception as e:  # reported by the fixture below
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()  # the ranks run while JAX computes its references
    reference = _jax_results(inputs, jax_side)
    thread.join(LAUNCH_TIMEOUT + 30)
    assert not thread.is_alive() and not failure, failure
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return dict(inputs=inputs, ranks=out, jax=reference, tmp=tmp)


def test_ranks_form_a_two_rank_data_axis(parity):
    assert [(r["rank"], r["world"], r["data"]) for r in parity["ranks"]] == [
        (0, 2, 2), (1, 2, 2)]


@pytest.mark.parametrize("case", ranks.BN_CASES)
def test_batch_norm_statistics_are_global(parity, case):
    """Values, input gradients and running averages of each rank are the
    global batch's (R = 1 on the joined batch); the parameter gradients of
    the ranks sum to R = 1's."""
    inp = parity["inputs"]
    x, cot = inp["bn"][case]
    ref = ranks.bn_run(case, x, cot, inp["bn_channels"], inp["bn_seed"])
    got = [r["bn"][case] for r in parity["ranks"]]
    for key in ("y", "dx"):
        _close_to_largest(np.concatenate([g[key] for g in got]), ref[key],
                          1e-5, f"{case} {key}")
    for key in ("dweight", "dbias"):
        _close_to_largest(got[0][key] + got[1][key], ref[key], 1e-5,
                          f"{case} {key}")
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
        _close_to_largest(got[0][key], ref[key], 1e-5, f"{case} {key}")


def test_dropout_ranks_draw_the_global_mask(parity):
    """Each rank's dropout (135 elements a rank: rank 1 counts from 135,
    inside a Philox group) is its rows of the single-process mask,
    bitwise; the two ranks' masks differ."""
    inp = parity["inputs"]
    ref = ranks.dropout_run(inp["dropout_x"], inp["dropout_seed"])
    got = [r["dropout"] for r in parity["ranks"]]
    np.testing.assert_array_equal(np.concatenate(got), ref)
    assert not np.array_equal(got[0] != 0, got[1] != 0)


def test_metrics_from_global_counts_match_jax(parity):
    ref = parity["jax"]["metrics"]
    for r in parity["ranks"]:
        assert r["metrics"].keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_train_step_at_two_ranks_matches_jax_mesh(parity):
    """One Adam step of ``Trainer.train_step`` at R = 2 against JAX's
    trainer on a 2-device ``data`` mesh from the same weights and batch:
    loss, metrics, every parameter and running average."""
    loss, metrics, params, batch_stats, grads = parity["jax"]["step"]
    for r in parity["ranks"]:
        got = r["step"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4)
        assert got["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        tree = state_dict_to_flax(got["state_dict"])
        _params_after_adam_close(tree["params"], params,
                                 grads_to_flax(got["grads"]), grads, 1e-4)
        _trees_close(tree["batch_stats"], batch_stats, 1e-4, "batch_stats")
    a, b = (r["step"]["state_dict"] for r in parity["ranks"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_two_ranks_equal_one_process_with_dropout_and_augmentation(parity):
    """Dropout on (``pallas``, rate 0.2) and ``DeviceAugment`` flips and
    noise: the ranks' step is the single process's on the joined batch."""
    aug = parity["inputs"]["augmented"]
    ref = ranks.trainer_step(aug["config"], aug["state_dict"], aug["images"],
                             aug["labels"], 3, aug["device_augment"])
    ref_tree = state_dict_to_flax(ref["state_dict"])
    ref_grads = grads_to_flax(ref["grads"])
    for r in parity["ranks"]:
        got = r["augmented"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        _trees_close(grads_to_flax(got["grads"]), ref_grads, 1e-4,
                     "gradients")
        tree = state_dict_to_flax(got["state_dict"])
        _params_after_adam_close(tree["params"], ref_tree["params"],
                                 grads_to_flax(got["grads"]), ref_grads, 1e-4)
        _trees_close(tree["batch_stats"], ref_tree["batch_stats"], 1e-4,
                     "batch_stats")


def test_remat_backward_late_and_outside_the_mesh_is_the_plain_one(parity):
    """On each rank: a ``Remat`` network's first forward inside
    ``data_parallel``, a second forward at another seed, then the first
    backward outside the mesh's block; the recompute runs under the
    forward's mesh and seeds, so its gradients are the plain network's
    (the same sums, also across the ranks) and its running averages too.
    The recompute reduces its batch moments over the ranks again, as JAX's
    does under ``pjit``: 13 batch norms reduce once forward and once
    backward (but the input's, whose moments are of the images), and the 7
    of the blocks once more in the recompute."""
    for rank in parity["ranks"]:
        plain, remat = rank["remat"][False], rank["remat"][True]
        largest = max(g.abs().max().item() for g in plain["grads"].values())
        for k, g in plain["grads"].items():
            err = (remat["grads"][k] - g).abs().max().item()
            assert err <= 1e-5 * largest, (k, err)
        for k, v in plain["state_dict"].items():
            assert torch.equal(remat["state_dict"][k], v), k
        assert remat["collectives"]["forward"] == plain["collectives"][
            "forward"] == {"all_reduce": 13}
        assert plain["collectives"]["backward"] == {"all_reduce": 12}
        assert remat["collectives"]["backward"] == {"all_reduce": 19}


@pytest.mark.parametrize("norm", ["batch", "batch_stats"])
def test_sharded_sliding_window_matches_jax_mesh(parity, norm):
    """The grid sharded over two ranks (36 patches padded to 40, 20 a rank:
    rank 1's block ends in 4 flag-0 rows) against JAX's engine on a
    2-device mesh, at ``EvalNorm`` ``ema`` (running averages) and
    ``batch_stats`` (each rank's own batches, as under ``shard_map``)."""
    ref_acc, ref_w = parity["jax"]["window"][norm]
    for r in parity["ranks"]:
        acc, weight = r["window"][norm]
        np.testing.assert_allclose(acc, ref_acc, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(weight, ref_w, rtol=1e-4, atol=1e-4)


def test_sliding_window_batch_stats_stay_per_rank(parity):
    """Each batch of the sharded grid lies on one rank, and its statistics
    are its own, so the sharded ``batch_stats`` result is one process's;
    reducing the statistics over the ranks (the training step's context)
    would mix two ranks' batches and change it."""
    win = parity["inputs"]["window"]
    acc, _ = ranks.window_run(
        dict(win["net_kw"], norm="batch_stats"),
        win["state_dicts"]["batch_stats"], win["volume"], win["patch"],
        win["stride"], win["batch"], win["net_kw"]["num_classes"])
    sharded = parity["ranks"][0]["window"]["batch_stats"][0]
    np.testing.assert_allclose(sharded, acc, rtol=1e-5, atol=1e-5)
    mixed = parity["ranks"][0]["window_global_stats"][0]
    assert np.abs(mixed - acc).max() > 1e-3


def test_sharded_slice_stacked_window_equals_one_process(parity):
    """The slice-stacked 2D grid takes the same sharded path: with a model
    that depends on each batch's mean, the sharded result is one
    process's (every batch lies on one rank, as the rows are blocks of
    whole batches)."""
    inp = parity["inputs"]
    acc, weight = ranks.stacked_window_run(inp["stack"], inp["stack_weights"])
    for r in parity["ranks"]:
        np.testing.assert_allclose(r["window_2d"][0], acc, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["window_2d"][1], weight, rtol=1e-5,
                                   atol=1e-5)


def test_every_rank_resumes_from_rank_zeros_checkpoint(parity):
    """``Restore: true`` after the one-step run: both ranks resume at step
    1 from the checkpoint rank 0 wrote and stop at ``MaxIterations`` 2."""
    assert [r["resumed_step"] for r in parity["ranks"]] == [2, 2]


def test_rank_zero_alone_writes_checkpoints_sidecar_and_logs(parity):
    """``Trainer.train`` at R = 2 for one step: rank 0 writes the sidecar,
    the checkpoints and opens the log directory; rank 1 writes nothing."""
    writes = [r["writes"] for r in parity["ranks"]]
    assert writes[1] == []
    assert writes[0].count("sidecar") == 1
    assert writes[0].count("checkpoint") >= 1
    assert "log:train" in writes[0]


# ----------------------------------------------------------------------
# the CLI at --devices 2
# ----------------------------------------------------------------------
def test_cli_trains_and_evaluates_on_two_ranks(tmp_path):
    make_dataset_dir(str(tmp_path), "training", num_cases=2,
                     rng=np.random.default_rng(1))
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1,
                     rng=np.random.default_rng(2))
    cfg = _config(tmp_path, "cli", batch=2, dropout=0.1)
    assert main(["-p", "train", "--config_json", cfg, "--device", "cpu",
                 "--devices", "2"]) is None  # ran in two spawned ranks
    log = tmp_path / "log_cli" / "train"
    events = [f for f in os.listdir(log) if f.startswith("events.out")]
    assert len(events) == 1
    with open(log / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys)) and ("loss/0.total_loss", 1) in keys
    ckpt = torch.load(tmp_path / "ckpt_cli" / "ckpt_1.pt", weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    assert (tmp_path / "ckpt_cli" / "network_config.json").exists()
    assert main(["-p", "evaluate", "--config_json", cfg, "--device", "cpu",
                 "--devices", "2"]) is None
    assert (tmp_path / "evaluate" / "case_0" / "label_tf.nii.gz").exists()


def test_cli_refuses_more_cards_than_exist(tmp_path, monkeypatch):
    """Nothing falls back to fewer cards or to the CPU: two ranks on a
    machine that shows one card raise before anything starts, and no card
    at all raises too."""
    cfg = _config(tmp_path, "cards")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards, torch sees 1"):
        main(["-p", "train", "--config_json", cfg, "--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-p", "train", "--config_json", cfg, "--devices", "2"])


# ----------------------------------------------------------------------
# arithmetic, without processes
# ----------------------------------------------------------------------
def test_mesh_without_a_group_is_one_rank():
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.data, mesh.parallel) == (
        1, 0, 1, False)
    x = torch.arange(3.0)
    assert mesh.sum(x) is x  # no collective on one rank
    with data_parallel(mesh):
        assert active_mesh() is None
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, device="cpu")


@pytest.mark.parametrize("world,data,space,match", [
    (4, 0, 3, "space_parallel=3 must divide 4"),
    (6, 0, 4, "space_parallel=4 must divide 6"),
    (4, 4, 2, "mesh 4x2 needs 8 devices, have 4"),
    (8, 2, 8, "mesh 2x8 needs 16 devices, have 8")])
def test_space_parallel_refusals_match_jax(monkeypatch, world, data, space,
                                           match):
    """JAX's ``make_mesh`` refusals, message for message: a space axis that
    does not divide the ranks, a grid larger than the ranks."""
    devices = jax.devices("cpu")[:1] * world
    with pytest.raises(ValueError, match=match):
        jax_make_mesh(data, space_parallel=space, devices=devices)
    monkeypatch.setattr(mesh_module, "_world", lambda: (world, 0))
    with pytest.raises(ValueError, match=match):
        make_mesh(data, space, device="cpu")


@pytest.mark.parametrize("extent,levels", [(20, 2), (24, 4), (8, 3)])
def test_space_parallel_refuses_extents_the_grid_cannot_split(extent,
                                                              levels):
    """``dim % (S * 2**levels)``: the port refuses what JAX's
    ``validate_partition`` refuses, with its message."""
    from vnet_tpu.parallel.spatial import validate_partition as jax_validate
    from vnet_tpu_torch.parallel.spatial import validate_partition
    for fn in (jax_validate, validate_partition):
        with pytest.raises(ValueError, match="must be a multiple of shards"):
            fn((extent, 16, 16), 0, shards=2, num_levels=levels)


def test_grid_ranks_are_data_major(monkeypatch):
    """Rank r of a 2 x 3 grid is data index r // 3, space index r % 3, as
    JAX reshapes its devices into ``(data, space)``; ``batch_rows`` goes by
    the data index and ``Mesh.slab`` by the space index."""
    grid = [Mesh(6, r, r, 2, 1, torch.device("cpu"), 3) for r in range(6)]
    assert [(m.data_index, m.space_index) for m in grid] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [batch_rows(m, 4) for m in grid] == [(0, 2)] * 3 + [(2, 4)] * 3
    assert [m.slab(24) for m in grid[:3]] == [(0, 8), (8, 16), (16, 24)]
    assert grid[4].space_ranks == (3, 4, 5)


@pytest.mark.parametrize("impl", ["pallas", "xla", "bits8"])
@pytest.mark.parametrize("shape,space", [((2, 3, 8, 4, 5), 2),
                                         ((3, 2, 12, 3, 2), 4),
                                         ((1, 5, 6, 2, 2), 3)])
def test_dropout_row_map_draws_the_slab_of_the_global_mask(shape, space,
                                                           impl):
    """The plain version at ``L < G``: each space rank's slab (first
    spatial axis, in the ``(B, *spatial, C)`` counter order: ``B`` runs of
    ``L`` elements ``G`` apart) of a data rank's rows is bitwise that part
    of the single process's output; slab boundaries fall inside Philox
    groups for odd ``L``."""
    from vnet_tpu_torch.ops.dropout import dropout_params, dropout_plain
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape)
                         .astype(np.float32)).contiguous(
                             memory_format=torch.channels_last_3d)
    params = dropout_params(0.3, impl)
    whole = dropout_plain(x, 17, 2, *params, base=40)
    per = shape[2] // space
    for s in range(space):
        slab = x[:, :, s * per:(s + 1) * per]
        row_len = slab[0].numel()
        got = dropout_plain(slab, 17, 2, *params, base=40 + s * row_len,
                            row_len=row_len, row_stride=row_len * space)
        assert torch.equal(got, whole[:, :, s * per:(s + 1) * per]), s


@pytest.mark.parametrize("base", [0, 3, 135])
def test_dropout_row_map_at_l_equal_g_is_todays_mask(base):
    """``L = G`` (and ``L = n``) is the contiguous counter, bit for bit the
    mask without a row map; a row map that does not fit raises."""
    from vnet_tpu_torch.ops.dropout import (dropout_apply, dropout_params,
                                            dropout_plain, keep_mask)
    x = torch.randn(4, 3, 5, 4, 3)
    params = dropout_params(0.2, "pallas")
    ref = dropout_plain(x, 5, 1, *params, base=base)
    n, row = x.numel(), x.numel() // 4
    for row_len, row_stride in ((row, row), (n, n), (n, 2 * n)):
        got = dropout_apply(x, 5, 1, *params, base, row_len, row_stride)
        assert torch.equal(got, ref), (row_len, row_stride)
    assert torch.equal(keep_mask(n, 5, 1, params[0], base=base, row_len=row,
                                 row_stride=row),
                       keep_mask(n, 5, 1, params[0], base=base))
    with pytest.raises(ValueError, match="does not fit"):
        dropout_apply(x, 5, 1, *params, base, 7, 7)
    with pytest.raises(ValueError, match="does not fit"):
        dropout_apply(x, 5, 1, *params, base, row, row - 1)


@pytest.mark.parametrize("batch,devices,expect", [
    (4, 8, 4), (96, 8, 8), (3, 2, 1), (6, 4, 2), (5, 1, 1)])
def test_data_axis_is_gcd_of_batch_and_devices(batch, devices, expect):
    assert data_parallel_size(batch, 0, devices) == expect
    assert data_parallel_size(batch, 2, devices) == 2


def test_multislice_mesh_is_dcn_major(monkeypatch):
    """8 ranks on 2 nodes of 4 GPUs (torchrun's order): ranks 0-3 on node
    0, 4-7 on node 1, each node's GPUs minor."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for rank in range(8):
        monkeypatch.setattr(mesh_module, "_world", lambda r=rank: (8, r))
        mesh = make_multislice_mesh(device="cpu")
        assert (mesh.dcn, mesh.data, mesh.rank) == (2, 8, rank)
        assert (mesh.node, mesh.local_rank) == (rank // 4, rank % 4)
    with pytest.raises(ValueError, match="needs 6 devices, have 8"):
        make_multislice_mesh(ici_data_parallel=3, dcn_data_parallel=2,
                             device="cpu")


def _mesh(rank, data):
    return Mesh(data, rank, rank, data, 1, torch.device("cpu"))


def test_batch_rows_are_contiguous_blocks():
    rows = [batch_rows(_mesh(r, 4), 96) for r in range(4)]
    assert rows == [(0, 24), (24, 48), (48, 72), (72, 96)]
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(_mesh(0, 4), 6)


def test_pad_batch_to_multiple():
    batch = np.arange(5)[:, None]
    padded, n = pad_batch_to_multiple(batch, 4)
    assert n == 5 and padded[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


class _Samples:
    """Samples whose values come from the index and, like a random host
    transform, from the module generator of ``data/rand.py``."""

    def __init__(self, n):
        self.n, self.loaded = n, []

    def __len__(self):
        return self.n

    def get_sample(self, i):
        from vnet_tpu_torch.data.rand import get_rng
        self.loaded.append(i)
        return (np.full((2,), i, np.float32)
                + get_rng().normal(size=2).astype(np.float32),
                np.array(i))


@pytest.mark.parametrize("backend,workers", [("thread", 0),
                                             ("process", 2)])
def test_loader_rank_rows_join_to_the_single_process_batch(backend,
                                                           workers):
    """Every rank draws the epoch order of one loader and loads only its
    rows; the ranks' rows join to the single loader's batches (sample ids
    always; values too where host randomness is seeded per sample, the
    process backend)."""
    def batches(rows):
        ds = _Samples(11)
        loader = BatchLoader(ds, 4, seed=5, num_workers=workers,
                             backend=backend, rows=rows)
        return [b for _ in range(2) for b in loader.epoch()], ds.loaded

    whole, _ = batches(None)
    parts = [batches(batch_rows(_mesh(r, 2), 4)) for r in range(2)]
    assert len(whole) == 4 and all(len(p[0]) == 4 for p in parts)
    for k, batch in enumerate(whole):
        ids = np.concatenate([p[0][k][1] for p in parts])
        np.testing.assert_array_equal(ids, batch[1])
        if backend == "process":
            np.testing.assert_array_equal(
                np.concatenate([p[0][k][0] for p in parts]), batch[0])
    if workers == 0:  # the synchronous loader records what it loaded
        for r, (rank_batches, loaded) in enumerate(parts):
            assert sorted(loaded) == sorted(
                int(i) for b in rank_batches for i in b[1])
    with pytest.raises(ValueError, match="drop_remainder"):
        BatchLoader(_Samples(4), 4, drop_remainder=False, rows=(0, 2))


def test_device_augment_draws_are_the_global_batch_rows():
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    images = torch.zeros(6, 3, 3, 3, 1)
    whole = random_noise(gen(), images, 5.0)
    part = random_noise(gen(), images[2:4], 5.0, rows=(2, 4, 6))
    assert torch.equal(part, whole[2:4])


def test_dp_bench_mask_comparison_joins_rank_rows():
    """``tools/dp_bench.compare_masks``: the ranks' packed rows join to the
    one process's; a flipped decision on a nonzero input counts, one on a
    zero input does not."""
    rng = np.random.default_rng(4)
    dropped = rng.random((4, 16)) < 0.3
    valid = rng.random((4, 16)) < 0.9

    def packed(d, v):
        return [np.packbits(d.reshape(-1)), np.packbits(v.reshape(-1))]

    ref = [packed(dropped, valid)]
    ranks = [[packed(dropped[2 * r:2 * r + 2], valid[2 * r:2 * r + 2])]
             for r in range(2)]
    assert dp_bench.compare_masks(ref, ranks) == (1, int(valid.sum()), 0)
    flipped = dropped.copy()
    i = np.flatnonzero(valid)[0]
    j = np.flatnonzero(~valid)[0]
    flipped.reshape(-1)[[i, j]] ^= True
    ranks = [[packed(flipped[2 * r:2 * r + 2], valid[2 * r:2 * r + 2])]
             for r in range(2)]
    assert dp_bench.compare_masks(ref, ranks)[2] == 1


def test_dp_bench_holds_parameters_to_adams_amplification():
    """``tools/dp_bench.compare_train``: a parameter whose gradient changes
    sign near 0 may move by up to 2 lr (Adam's first step); the same move
    where the gradients agree is an error."""
    grads = {"w": torch.tensor([0.5, 1e-6, -0.2])}
    state = {"w": torch.tensor([1.0, 0.3, -0.4]), "bn.mean": torch.ones(2)}
    ref = dict(loss=1.0, grads=grads, state=state)
    step = 2 * dp_bench.LR * 1e-6 / (1e-6 + dp_bench.ADAM_EPS)  # 0.0198
    flip = dict(loss=1.0, grads={"w": torch.tensor([0.5, -1e-6, -0.2])},
                state={"w": state["w"] + torch.tensor([0.0, step, 0.0]),
                       "bn.mean": torch.ones(2)})
    errs, amplified, amp_err = dp_bench.compare_train(ref, flip)
    assert errs["parameters"] <= 1e-6 and amplified == 1
    assert amp_err == pytest.approx(step, rel=1e-5)
    moved = dict(flip, grads=grads)
    assert dp_bench.compare_train(ref, moved)[0]["parameters"] > 1e-3
