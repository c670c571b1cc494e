"""Spatial partitioning of the port (``parallel/{halo,spatial,tensor}.py``,
the trainer's ``Mesh.SpaceParallel``) against JAX's on conftest's 8 CPU
devices, and against the port's own single process.

Four ``gloo`` ranks are spawned once for the module (``parallel.launch``,
a ``file://`` rendezvous under the test's directory); their functions live
in the JAX-free ``torch_spatial_ranks.py``. They form a ``1 x 4`` grid
(one space group of four: the middle ranks have two neighbours) and a
``2 x 2`` grid (two data rows of two space ranks) while this process
computes JAX's results on ``(8 / S) x S`` meshes. Tiny sizes: 2 levels, 4
or 16 channels, the sharded axis ``8 * S`` long, float32.

Tolerances, with their reasons:

* Halo exchange: the same float32 values moved, bitwise.
* Sharded convolution, the whole-network forward: two frameworks' float32
  convolutions summed in other orders, ``atol = rtol = 1e-5`` (JAX's own
  test of its sharded forward), ``1e-4`` where batch statistics are
  reduced over the shards (``batch_stats``, ``instance``, ``group``, and
  the adaptive packing's longer sums), as JAX's tests allow.
* Two SGD steps of ``spatial_sharded_train_step`` and of the trainer at
  ``SpaceParallel`` 2 against JAX's: losses ``rtol = 1e-4``, parameters
  and running averages ``rtol = 2e-4, atol = 2e-5`` (JAX's own bound for
  its sharded step against its unsharded one). SGD, as JAX's tests take
  it: Adam's first step turns a near-zero gradient's rounding into a move
  of ``lr``.
* The trainer at ``2 x 2`` against its own single process, dropout and
  device augmentation on: gradients within ``1e-4`` of the largest, the
  parameters after Adam within its first-step amplification of the
  gradients' difference plus ``1e-4`` of the largest (the rule of
  ``tests/test_torch_parallel.py``), every dropout mask joined over the
  grid bitwise.
* ``tp_conv`` against JAX's: ``atol = rtol = 1e-5``.
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_spatial_ranks as ranks
from fixtures import make_dataset_dir
from torch_parity import random_variables
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from vnet_tpu.parallel.halo import sharded_conv as jax_sharded_conv
from vnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vnet_tpu.parallel.spatial import \
    spatial_sharded_forward as jax_spatial_forward
from vnet_tpu.parallel.spatial import \
    spatial_sharded_train_step as jax_spatial_train_step
from vnet_tpu.parallel.spatial import \
    validate_partition as jax_validate_partition
from vnet_tpu.parallel.tensor import make_tp_mesh as jax_make_tp_mesh
from vnet_tpu.parallel.tensor import replicate as jax_replicate
from vnet_tpu.parallel.tensor import shard_kernel as jax_shard_kernel
from vnet_tpu.parallel.tensor import tp_conv as jax_tp_conv
from vnet_tpu.train.trainer import Trainer as JaxTrainer
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)
from vnet_tpu_torch.parallel import launch
from vnet_tpu_torch.parallel.spatial import validate_partition
from vnet_tpu_torch.parallel.tensor import TPMesh, tp_conv

RANKS = 4
LAUNCH_TIMEOUT = 300.0
LR = 1e-3  # the Adam config's learning rate at step 0
ADAM_EPS = 1e-8
HALO_CASES = {f"rank{r}_k{k}": (r, k) for r in (2, 3) for k in (3, 5)}
FORWARD_CASES = {
    "direct": dict(norm="batch", impl="direct", axis=0, shape=(32, 8, 8, 1)),
    "packed": dict(norm="batch", impl="packed", axis=0, shape=(32, 8, 8, 1)),
    "batch_stats": dict(norm="batch_stats", impl="direct", axis=0,
                        shape=(32, 8, 8, 1)),
    "instance": dict(norm="instance", impl="direct", axis=0,
                     shape=(32, 8, 8, 1)),
    "group": dict(norm="group", impl="direct", axis=0, shape=(32, 8, 8, 1)),
    "2d": dict(norm="batch", impl="direct", axis=0, shape=(32, 8, 1)),
    "adaptive_axis0": dict(norm="batch", impl="packed", axis=0,
                           shape=(32, 8, 8, 1), channels=16, lanes=64),
    "adaptive_axis2": dict(norm="batch", impl="packed", axis=2,
                           shape=(8, 8, 32, 1), channels=16, lanes=64),
    "multichannel": dict(norm="batch", impl="direct", axis=0,
                         shape=(32, 8, 8, 2)),
}
FORWARD_TOL = {"direct": 1e-5, "packed": 1e-5, "2d": 1e-5,
               "multichannel": 1e-5}  # the rest: 1e-4
TRAIN_CASES = {
    "weighted_sorensen": dict(loss="weighted_sorensen",
                              weights=(0.1, 0.5, 1.0), impl="direct",
                              shards=4, axis=0),
    "mixed_jaccard": dict(loss="mixed_jaccard", weights=(), impl="direct",
                          shards=4, axis=0),
    "packed_axis1": dict(loss="sorensen", weights=(), impl="packed",
                         shards=2, axis=1),
}
TP_CASES = {"rank2": ((2, 8, 8, 4), (8, 4, 3, 3)),
            "rank3": ((2, 8, 8, 8, 4), (8, 4, 3, 3, 3))}


def _net_kw(c):
    rank = len(c["shape"]) - 1
    return dict(num_classes=2, dropout_rate=0.0,
                num_channels=c.get("channels", 4), num_levels=2,
                num_convolutions=(1, 1), bottom_convolutions=1,
                norm=c["norm"], conv_impl=c["impl"],
                packed_target_lanes=c.get("lanes", 0))


def _port_kw(c):
    return dict(_net_kw(c), spatial_rank=len(c["shape"]) - 1,
                in_channels=c["shape"][-1])


def _pipeline(tmp, patch):
    base = [{"name": "ManualNormalization",
             "variables": {"windowMin": 0, "windowMax": 200}},
            {"name": "Padding", "variables": {"output_size": list(patch)}}]
    crop = [{"name": "RandomCrop",
             "variables": {"output_size": list(patch), "drop_ratio": 1.0,
                           "min_pixel": 1}}]
    path = tmp / f"pipeline_{'x'.join(map(str, patch))}.yaml"
    path.write_text(yaml.safe_dump({"preprocess": {
        "train": {"3D": base + crop}, "test": {"3D": base + crop},
        "evaluate": {"3D": base}}}))
    return str(path)


def _config(tmp, name, patch, mesh=None, optimizer="SGD", lr=1e-2,
            dropout=0.0, batch=2, data="training", remat=False,
            convolutions=(1, 1), **setting):
    """A 2-level, 4-channel VNet config; ``mesh``: ``(data, space)``."""
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": str(tmp / data),
                     "TestingDataDirectory": str(tmp / data)},
            "SegmentationClasses": [0, 1], "Restore": False,
            "LogDir": str(tmp / f"log_{name}"),
            "CheckpointDir": str(tmp / f"ckpt_{name}"),
            "BatchSize": batch, "PatchShape": list(patch), "Testing": False,
            "MaxIterations": 2, "LogInterval": 1, "LoaderWorkers": 0,
            "Networks": {"Name": "VNet", "Dropout": dropout, "NumChannel": 4,
                         "NumLevels": 2,
                         "NumConvolutions": list(convolutions),
                         "BottomConvolutions": 1, "Norm": "batch",
                         "DropoutImpl": "pallas", "DwImpl": "pallas",
                         "Remat": remat},
            "Loss": {"Name": "weighted_sorensen", "Weights": [0.1, 1.0]},
            "Optimizer": {"Name": optimizer, "InitialLearningRate": lr,
                          "Decay": {"Factor": 0.99, "Steps": 100}},
            "Pipeline": _pipeline(tmp, patch), "Precision": "float32",
            **setting},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp / "evaluate")},
            "CheckpointPath": str(tmp / f"ckpt_{name}"),
            "Stride": list(patch), "BatchSize": 2,
            "Pipeline": _pipeline(tmp, patch)}}
    if mesh is not None:
        tree["TrainingSetting"]["Mesh"] = {"DataParallel": mesh[0],
                                           "SpaceParallel": mesh[1]}
    path = tmp / f"config_{name}.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _jax_mesh(space):
    return jax_make_mesh(data_parallel=8 // space, space_parallel=space)


# ----------------------------------------------------------------------
# inputs and JAX's results
# ----------------------------------------------------------------------
def _inputs(tmp):
    rng = np.random.default_rng(20)
    inp, jax_side = {"halo": {}, "forward": {}, "train": {}, "tp": {}}, {}
    for name, (rank, k) in HALO_CASES.items():
        shape = (32, 8, 8, 3)[:rank] + (3,)
        vol = rng.normal(size=shape).astype(np.float32)
        weight = (rng.normal(size=(4, 3) + (k,) * rank) * 0.2).astype(
            np.float32)
        m = 8 + 2 * (k // 2)
        cot_h = rng.normal(size=(4 * m,) + shape[1:]).astype(np.float32)
        cot_c = rng.normal(size=shape[:-1] + (4,)).astype(np.float32)
        inp["halo"][name] = (vol, weight, cot_h, cot_c)
    for name, c in FORWARD_CASES.items():
        net = jax_build_network("VNet", **_net_kw(c))
        vol = rng.normal(size=c["shape"]).astype(np.float32)
        variables = random_variables(net, np.random.default_rng(21),
                                     jnp.zeros((1,) + c["shape"]),
                                     train=False)
        inp["forward"][name] = dict(net_kw=_port_kw(c), volume=vol,
                                    axis=c["axis"],
                                    state_dict=flax_to_state_dict(variables))
        jax_side[("forward", name)] = (net, variables)
    for name, c in TRAIN_CASES.items():
        shape = [16, 8, 8]
        shape[c["axis"]] = 8 * c["shards"]
        kw = dict(num_classes=3, dropout_rate=0.0, num_channels=4,
                  num_levels=2, num_convolutions=(1, 1),
                  bottom_convolutions=1, norm="batch", conv_impl=c["impl"])
        net = jax_build_network("VNet", **kw)
        images = rng.normal(size=(2, *shape, 1)).astype(np.float32)
        labels = rng.integers(0, 3, (2, *shape)).astype(np.int32)
        variables = random_variables(net, np.random.default_rng(22),
                                     jnp.asarray(images), train=True)
        inp["train"][name] = dict(
            net_kw=kw, state_dict=flax_to_state_dict(variables), lr=1e-2,
            loss=c["loss"], classes=3, weights=c["weights"],
            axis=c["axis"], shards=c["shards"], images=images,
            labels=labels)
        jax_side[("train", name)] = (net, variables)
    for name, (xs, ws) in TP_CASES.items():
        inp["tp"][name] = (rng.normal(size=xs).astype(np.float32),
                           (rng.normal(size=ws) * 0.2).astype(np.float32))

    make_dataset_dir(str(tmp), "training", num_cases=2,
                     rng=np.random.default_rng(1), shape=(32, 16, 16))
    make_dataset_dir(str(tmp), "training16", num_cases=2,
                     rng=np.random.default_rng(2), shape=(16, 16, 16))
    cfg = _config(tmp, "trainer", (32, 16, 16), mesh=(2, 2))
    jtrainer = JaxTrainer(jax_load_config(cfg), log=False)
    images = rng.normal(50.0, 20.0, (2, 32, 16, 16, 1)).astype(np.float32)
    variables = random_variables(jtrainer.network, np.random.default_rng(23),
                                 jnp.asarray(images), train=True)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtrainer.tx.init(variables["params"]))
    sd = flax_to_state_dict(variables)
    labels = (rng.random((2, 32, 16, 16)) > 0.7).astype(np.int32)
    inp["trainer"] = dict(config=cfg, state_dict=sd, images=images,
                          labels=labels)
    jax_side["trainer"] = (jtrainer, jstate)

    aug = dict(patch=(16, 16, 16), optimizer="Adam", lr=LR, dropout=0.2,
               batch=4, data="training16")
    images = rng.normal(50.0, 20.0, (4, 16, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (4, 16, 16, 16)).astype(np.int32)
    inp["augmented"] = dict(config=_config(tmp, "aug", mesh=(2, 2), **aug),
                            single=_config(tmp, "aug_one", **aug),
                            remat={r: _config(tmp, f"aug_remat_{r}",
                                              mesh=(2, 2), remat=r,
                                              convolutions=(1, 2), **aug)
                                   for r in (False, True)},
                            state_dict=sd, images=images, labels=labels,
                            device_augment=((0, 1, 2), 5.0))
    # two identical cases: what the rows load differs only by the draws
    make_dataset_dir(str(tmp), "twins", num_cases=1,
                     rng=np.random.default_rng(3), shape=(32, 16, 16))
    shutil.copytree(tmp / "twins" / "case_0", tmp / "twins" / "case_1")
    inp["draws"] = _config(tmp, "draws", (16, 16, 16), mesh=(2, 2),
                           data="twins", LoaderWorkers=1)
    scan = dict(patch=(16, 16, 16), data="training16", ScanSteps=2)
    inp["scan"] = dict(config=_config(tmp, "scan", mesh=(2, 2), **scan),
                       single=_config(tmp, "scan_one", **scan),
                       state_dict=sd)
    return inp, jax_side


def _jax_train(inp, js, out):
    """JAX's ``spatial_sharded_train_step``, two SGD steps a case."""
    for name, case in inp["train"].items():
        net, variables = js[("train", name)]
        tx = optax.sgd(case["lr"])
        step = jax_spatial_train_step(
            net, tx, _jax_mesh(case["shards"]), loss_name=case["loss"],
            num_classes=3, weights=case["weights"],
            spatial_axis=case["axis"])
        carry = (variables["params"], variables["batch_stats"],
                 tx.init(variables["params"]))
        losses = []
        for i in range(2):
            carry, loss = step(carry, jnp.asarray(case["images"]),
                               jnp.asarray(case["labels"]),
                               jax.random.PRNGKey(100 + i))
            losses.append(float(loss))
        out[name] = dict(losses=losses, params=jax.device_get(carry[0]),
                         batch_stats=jax.device_get(carry[1]))


def _jax_results(inp, js):
    out = {"halo": {}, "forward": {}, "train": {}, "tp": {}}
    # the train steps trace and compile in a thread of their own, beside
    # the rest (XLA compiles without the GIL)
    train = threading.Thread(target=_jax_train, args=(inp, js, out["train"]))
    train.start()
    mesh4 = _jax_mesh(4)
    for name, (vol, weight, cot_h, cot_c) in inp["halo"].items():
        rank = vol.ndim - 1
        spec = P(*(["space"] + [None] * rank))
        h = weight.shape[2] // 2
        halo = shard_map(lambda v, h=h: jax_halo_exchange(v, h, "space", 0),
                         mesh=mesh4, in_specs=spec, out_specs=spec)
        kernel = jnp.asarray(np.transpose(
            weight, tuple(range(2, weight.ndim)) + (1, 0)))
        sharded = jax_sharded_conv(mesh4, "space", 0)

        @jax.jit
        def both(v, ch, cc, halo=halo, sharded=sharded, kernel=kernel):
            y, vjp = jax.vjp(halo, v)
            yc, vjp_c = jax.vjp(lambda u: sharded(u, kernel), v)
            return y, vjp(ch)[0], yc, vjp_c(cc)[0]

        out["halo"][name] = dict(zip(
            ("halo", "halo_dx", "conv", "conv_dx"),
            map(np.asarray, both(jnp.asarray(vol), jnp.asarray(cot_h),
                                 jnp.asarray(cot_c)))))
    for name, case in inp["forward"].items():
        net, variables = js[("forward", name)]
        out["forward"][name] = np.asarray(jax.device_get(jax_spatial_forward(
            net, variables, jnp.asarray(case["volume"]), mesh4,
            spatial_axis=case["axis"])))
    jtrainer, jstate = js["trainer"]
    step = inp["trainer"]
    losses = []
    for _ in range(2):
        jstate, res = jtrainer.train_step(jstate, step["images"],
                                          step["labels"],
                                          jax.random.PRNGKey(0))
        losses.append(float(res.loss))
    out["trainer"] = dict(losses=losses,
                          params=jax.device_get(jstate.params),
                          batch_stats=jax.device_get(jstate.batch_stats))
    tp_mesh = jax_make_tp_mesh(4, devices=jax.devices()[:4])
    for name, (x, w) in inp["tp"].items():
        kernel = jnp.asarray(np.transpose(
            w, tuple(range(2, w.ndim)) + (1, 0)))
        out["tp"][name] = np.asarray(jax.device_get(jax_tp_conv(
            tp_mesh, jax_replicate(tp_mesh, jnp.asarray(x)),
            jax_shard_kernel(tp_mesh, kernel))))
    train.join()
    assert len(out["train"]) == len(inp["train"]), "a JAX train case failed"
    return out


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    inputs, jax_side = _inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    failure = []

    def run():
        try:
            launch(ranks.spatial_ranks, RANKS, backend="gloo", device="cpu",
                   init_method=f"file://{tmp / 'rendezvous'}",
                   args=(str(tmp),), timeout=LAUNCH_TIMEOUT)
        except Exception as e:  # reported below
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()  # the ranks run while JAX computes its references
    reference = _jax_results(inputs, jax_side)
    thread.join(LAUNCH_TIMEOUT + 30)
    assert not thread.is_alive() and not failure, failure
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)]
    return dict(inputs=inputs, ranks=out, jax=reference, tmp=tmp)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _trees_close(got, ref, rtol, atol, what):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys(), what
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {key}")


def _close_to_largest(got, ref, rtol, what):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    largest = max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        err = np.abs(got[key] - value).max()
        assert err <= rtol * largest, (
            f"{what} {key}: max |diff| {err:.3g} > {rtol * largest:.3g}")


def _adam_first(g):
    g = np.asarray(g, np.float64)
    return g / (np.abs(g) + ADAM_EPS)


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
def test_ranks_form_the_grids(spatial):
    """Ranks are data-major, space-minor, as JAX reshapes its devices."""
    assert [r["grid"] for r in spatial["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]
    assert [r["space_ranks"] for r in spatial["ranks"]] == [
        (0, 1), (0, 1), (2, 3), (2, 3)]


@pytest.mark.parametrize("name", sorted(HALO_CASES))
def test_halo_exchange_and_sharded_conv_match_jax(spatial, name):
    """Each of four ranks' halo'd slab (ring ends zero) and sharded SAME
    convolution, forward and input gradient, against JAX's ``ppermute``
    under ``shard_map``: the halo moves values bitwise."""
    ref = spatial["jax"]["halo"][name]
    vol, weight = spatial["inputs"]["halo"][name][:2]
    m = 8 + 2 * (weight.shape[2] // 2)
    for s, r in enumerate(spatial["ranks"]):
        got = r["halo"][name]
        np.testing.assert_array_equal(got["halo"],
                                      ref["halo"][s * m:(s + 1) * m])
        np.testing.assert_allclose(got["halo_dx"],
                                   ref["halo_dx"][8 * s:8 * (s + 1)],
                                   rtol=1e-6, atol=1e-6)
        for key in ("conv", "conv_dx"):
            np.testing.assert_allclose(got[key], ref[key][8 * s:8 * (s + 1)],
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_sharded_forward_matches_jax(spatial, name):
    tol = FORWARD_TOL.get(name, 1e-4)
    ref = spatial["jax"]["forward"][name]
    for r in spatial["ranks"]:
        np.testing.assert_allclose(r["forward"][name], ref, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_jax(spatial, name):
    """Two SGD steps of ``spatial_sharded_train_step``: losses, parameters
    and running averages against JAX's (dropout 0)."""
    ref = spatial["jax"]["train"][name]
    for r in spatial["ranks"]:
        got = r["train"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        tree = state_dict_to_flax(got["state_dict"])
        _trees_close(tree["params"], ref["params"], 2e-4, 2e-5, "params")
        _trees_close(tree["batch_stats"], ref["batch_stats"], 2e-4, 2e-5,
                     "batch_stats")


def test_trainer_at_space_parallel_matches_jax_trainer(spatial):
    """``Mesh: {DataParallel: 2, SpaceParallel: 2}``: two SGD steps of the
    port's trainer on four ranks against JAX's trainer on a 2 x 2 mesh
    from the same weights and batch."""
    ref = spatial["jax"]["trainer"]
    states = []
    for r in spatial["ranks"]:
        got = r["trainer"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        tree = state_dict_to_flax(got["state_dict"])
        _trees_close(tree["params"], ref["params"], 2e-4, 2e-5, "params")
        _trees_close(tree["batch_stats"], ref["batch_stats"], 2e-4, 2e-5,
                     "batch_stats")
        states.append(got["state_dict"])
    for k in states[0]:
        assert all(torch.equal(states[0][k], s[k]) for s in states), k


def test_trainer_grid_equals_one_process_with_dropout_and_augmentation(
        spatial):
    """Dropout (``pallas``, rate 0.2) and device flips along every axis
    and noise on: the 2 x 2 grid's step is the single process's on the
    joined batch, and every dropout layer's mask, joined over the grid
    (slabs along the first spatial axis, rows along the batch), is the
    single process's bitwise."""
    aug = spatial["inputs"]["augmented"]
    ref = ranks.trainer_steps(aug["single"], aug["state_dict"],
                              aug["images"], aug["labels"], (3,),
                              aug["device_augment"], masks=True)
    grid = {r["augmented"]["mesh"]: r["augmented"] for r in spatial["ranks"]}
    assert len(ref["masks"]) > 0
    def joined(layer, which):  # slabs along dim 2, then rows along dim 0
        return np.concatenate([np.concatenate(
            [grid[(d, s)]["masks"][layer][which] for s in range(2)], axis=2)
            for d in range(2)], axis=0)

    for layer, (dropped, valid, _) in enumerate(ref["masks"]):
        got_dropped, got_valid = joined(layer, 0), joined(layer, 1)
        assert got_dropped.shape == dropped.shape, layer
        both = valid & got_valid
        assert both.sum() > 0.9 * valid.sum(), layer
        np.testing.assert_array_equal(got_dropped[both], dropped[both],
                                      err_msg=f"layer {layer}")
    ref_grads = grads_to_flax(ref["grads"])
    ref_tree = state_dict_to_flax(ref["state_dict"])
    for got in grid.values():
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        grads = grads_to_flax(got["grads"])
        _close_to_largest(grads, ref_grads, 1e-4, "gradients")
        tree = state_dict_to_flax(got["state_dict"])
        got_p, ref_p = dict(_flat(tree["params"])), dict(
            _flat(ref_tree["params"]))
        g_got, g_ref = dict(_flat(grads)), dict(_flat(ref_grads))
        largest = max(np.abs(v).max() for v in ref_p.values())
        for key, value in ref_p.items():
            allow = LR * np.abs(_adam_first(g_got[key])
                                - _adam_first(g_ref[key]))
            excess = (np.abs(got_p[key] - value.astype(np.float64))
                      - allow).max()
            assert excess <= 1e-4 * largest, key
        _close_to_largest(tree["batch_stats"], ref_tree["batch_stats"], 1e-4,
                          "batch_stats")


def test_remat_grid_equals_the_plain_grid(spatial):
    """``Remat: true`` on the 2 x 2 grid (dropout and device augmentation
    on, as above, two convolutions at level 2, so that a block holds a
    dropout that is not its last): on each rank the step's loss, running
    averages and forward masks are the plain grid's bitwise and its
    gradients within 1e-5 of the largest; every recomputed dropout layer's
    slab of the mask is its forward's, and the recompute's halo exchanges
    ran in the same order on the ranks (the step would hang otherwise)."""
    for rank in spatial["ranks"]:
        plain, remat = rank["remat"][False], rank["remat"][True]
        assert remat["losses"] == plain["losses"]
        for k, v in plain["state_dict"].items():
            if k.endswith(("running_mean", "running_var")):
                assert torch.equal(remat["state_dict"][k], v), k
        largest = max(g.abs().max().item() for g in plain["grads"].values())
        for k, g in plain["grads"].items():
            err = (remat["grads"][k] - g).abs().max().item()
            assert err <= 1e-5 * largest, (k, err)
        n = len(plain["masks"])
        assert len(remat["masks"]) > n
        forward = {}
        for (dropped, valid, i), (d_p, v_p, i_p) in zip(remat["masks"][:n],
                                                        plain["masks"]):
            assert i == i_p
            np.testing.assert_array_equal(dropped, d_p)
            forward[i] = dropped
        for dropped, _, i in remat["masks"][n:]:
            np.testing.assert_array_equal(dropped, forward[i])


def test_scan_steps_keep_the_space_axis(spatial):
    """``ScanSteps: 2`` through ``Trainer.train`` at 2 x 2 (two steps in
    one block, each space rank loading its row's samples) ends where one
    process ends (SGD, deterministic crops)."""
    scan = spatial["inputs"]["scan"]
    ref = ranks.trained(scan["single"], scan["state_dict"])
    for r in spatial["ranks"]:
        tree = state_dict_to_flax(r["scan"])
        _trees_close(tree["params"], state_dict_to_flax(ref)["params"],
                     2e-4, 2e-5, "params")


def test_data_rows_draw_their_own_host_transforms(spatial):
    """``LoaderWorkers: 1`` at 2 x 2 over two identical cases, each row
    loading one a step (crops of 16 of 32 along the first axis): the host
    transforms' generator is seeded from ``Seed``, the step and the data
    index, so the space ranks of a row crop alike and the two rows do
    not."""
    draws = {r["grid"]: r["draws"] for r in spatial["ranks"]}
    assert all(len(d) == 3 for d in draws.values())  # 2 steps, then the end
    for d in range(2):
        assert all(torch.equal(a, b)
                   for a, b in zip(draws[(d, 0)], draws[(d, 1)])), d
    assert not any(torch.equal(a, b)
                   for a, b in zip(draws[(0, 0)], draws[(1, 0)]))


@pytest.mark.parametrize("name", sorted(TP_CASES))
def test_tp_conv_matches_jax(spatial, name):
    ref = spatial["jax"]["tp"][name]
    for r in spatial["ranks"]:
        np.testing.assert_allclose(r["tp"][name], ref, rtol=1e-5, atol=1e-5)


def test_tp_conv_refuses_indivisible_channels():
    mesh = TPMesh(4, 0, None, torch.device("cpu"))
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="Cout=6 not divisible by model=4"):
        tp_conv(mesh, x, torch.zeros(6, 2, 3, 3))
    jmesh = jax_make_tp_mesh(4, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="Cout=6 not divisible by model=4"):
        jax_tp_conv(jmesh, jnp.zeros((1, 4, 4, 2)), jnp.zeros((3, 3, 2, 6)))


@pytest.mark.parametrize("shape,match", [
    ((12, 8, 8, 1), "must be a multiple"),
    ((16, 8, 8, 1), "smaller than the conv halo"),
    ((32, 8, 8, 1), None)])
def test_validate_partition_refuses_as_jax_does(shape, match):
    for fn in (validate_partition, jax_validate_partition):
        if match is None:
            fn(shape, 0, shards=4, num_levels=2)
        else:
            with pytest.raises(ValueError, match=match):
                fn(shape, 0, shards=4, num_levels=2)


def test_dryrun_tool_passes_on_four_ranks(spatial):
    for r in spatial["ranks"]:
        dry = r["dryrun"]
        assert dry["world"] == RANKS and dry["failed"] == [], dry


def test_cli_trains_and_evaluates_at_space_parallel(tmp_path):
    """``-p train --device cpu --devices 2`` with ``SpaceParallel: 2``
    (one data row of two space ranks; two loader threads, so the row's
    batch is broadcast from its first space rank), then ``-p evaluate``
    of its checkpoint, which holds the unsharded network."""
    make_dataset_dir(str(tmp_path), "training", num_cases=2,
                     rng=np.random.default_rng(1), shape=(16, 16, 16))
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1,
                     rng=np.random.default_rng(2), shape=(16, 16, 16))
    cfg = _config(tmp_path, "cli", (16, 16, 16), mesh=(1, 2), dropout=0.1,
                  optimizer="Adam", lr=1e-3, LoaderWorkers=2)
    assert main(["-p", "train", "--config_json", cfg, "--device", "cpu",
                 "--devices", "2"]) is None
    with open(tmp_path / "log_cli" / "train" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["value"] for r in rows if r["tag"] == "loss/0.total_loss"]
    assert losses and all(np.isfinite(losses))
    ckpt = torch.load(tmp_path / "ckpt_cli" / "ckpt_2.pt", weights_only=True)
    assert "output_conv.weight" in ckpt["model"]
    results = main(["-p", "evaluate", "--config_json", cfg, "--device",
                    "cpu"])  # the grid's checkpoint, in one process
    assert len(results) == 1 and os.path.exists(results[0])


def test_trainer_refuses_a_patch_the_grid_cannot_split(tmp_path):
    """A first extent that is not a multiple of ``S * 2**levels`` raises
    before any step (the port checks at build; JAX's GSPMD would pad)."""
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.parallel.mesh import Mesh
    from vnet_tpu_torch.train import Trainer

    cfg = load_config(_config(tmp_path, "bad", (12, 16, 16), mesh=(1, 2)))
    mesh = Mesh(2, 0, 0, 1, 1, torch.device("cpu"), 2, None, None)
    with pytest.raises(ValueError, match="must be a multiple"):
        Trainer(cfg, device="cpu", log=False, mesh=mesh)
