"""The rest of the model zoo — ``VNetLegacy`` (packed and direct), ``UNet``
and ``Dense`` — against the JAX modules, the factory's names and warnings,
checkpoints of every name, and the training CLI for each new name.

Same numpy input, same variables (``convert.py``), dropout 0, float32, on
the CPU. Sums run in another order on each side: logits are held at
``atol = rtol = 1e-4`` relative to the largest logit; parameter gradients
and running averages at ``rtol = 1e-4`` and ``atol = 1e-4`` of the largest
entry of their kind (``test_torch_packed_vnet.py``). Checkpoint round trips
are exact.
"""

import json
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_dataset_dir
from test_torch_packed_vnet import (assert_logits_close, assert_trees_close,
                                    jax_train, port_train)
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from vnet_tpu_torch.models import NETWORKS, build_network, eval_apply
from vnet_tpu_torch.train import checkpoints

from torch_parity import random_variables

SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1,
             dropout_rate=0.0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _build_pair(name, spatial, rng, conv_impl="packed", lanes=32, **extra):
    x = rng.normal(50.0, 20.0, size=(2,) + spatial + (1,)).astype(np.float32)
    kw = dict(SMALL, **extra)
    jkw = dict(kw, conv_impl=conv_impl, packed_target_lanes=lanes)
    jnet = jax_build_network(name, **jkw)
    variables = random_variables(jnet, rng, jnp.asarray(x), train=False)
    port = build_network(name, device="cpu", spatial_rank=len(spatial),
                         patch_shape=spatial, **jkw)
    return x, jnet, variables, port


@pytest.mark.parametrize("name,spatial,conv_impl,extra", [
    ("VNetLegacy", (16, 16, 16), "packed", {}),
    ("VNetLegacy", (16, 16, 16), "direct", {}),
    ("VNetLegacy", (16, 16), "packed",
     dict(num_convolutions=(2, 1), bottom_convolutions=2)),
    ("UNet", (16, 16, 16), "direct", {}),
    ("UNet", (16, 16), "auto", dict(norm="batch_stats")),
    ("Dense", (6, 6, 4), "packed", dict(num_levels=2)),
    ("Dense", (8, 6), "packed", dict(num_levels=3, activation="prelu")),
], ids=str)
def test_zoo_eval_and_train_equal_jax(name, spatial, conv_impl, extra, rng):
    x, jnet, variables, port = _build_pair(name, spatial, rng, conv_impl,
                                           **extra)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False,
                                mutable=["batch_stats"])[0])
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert_logits_close(eval_apply(port, torch.from_numpy(x)).numpy(), ref)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    out_ref, grads_ref, stats_ref = jax_train(jnet, variables, x, cot)
    out, grads, stats = port_train(port, variables, x, cot)
    assert_logits_close(out, out_ref)
    assert_trees_close(grads, grads_ref, "gradient")
    assert_trees_close(stats, stats_ref, "batch_stats")


def test_legacy_double_norm_variables_equal_jax(rng):
    """``pre_norm_i`` on every encoder and bottom conv, and on every
    decoder conv but the first of a multi-conv block."""
    x = np.zeros((1, 16, 16, 16, 1), np.float32)
    jnet = jax_build_network("VNetLegacy", **SMALL)
    shapes = jax.eval_shape(lambda k: jnet.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    port = build_network("VNetLegacy", device="cpu", **SMALL)
    names = {".".join(k.split(".")[:2]) for k in port.state_dict()
             if ".pre_norm_" in k}
    assert names == {".".join(p[:2]) for p, _ in _flat(shapes["params"])
                     if p[1].startswith("pre_norm_")}
    assert "decoder_level_2.pre_norm_2" in names
    assert "decoder_level_2.pre_norm_1" not in names
    assert "decoder_level_1.pre_norm_1" in names  # a one-conv block


@pytest.mark.parametrize("name", ["VNet", "VNetLegacy", "AttentionVNet"])
def test_packed_tree_has_the_direct_tree(name):
    """A packed JAX network has exactly the variables, keys and shapes, of
    a direct one, so checkpoints interchange between the two."""
    x = jnp.zeros((1, 16, 16, 16, 1))
    trees = [jax.eval_shape(
        lambda k, impl=impl: jax_build_network(
            name, conv_impl=impl, **SMALL).init(k, x),
        jax.random.PRNGKey(0)) for impl in ("packed", "direct")]
    flat = [dict(_flat_shapes(t)) for t in trees]
    assert flat[0] == flat[1]


def _flat_shapes(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "shape"):
            yield prefix + (k,), v.shape
        else:
            yield from _flat_shapes(v, prefix + (k,))


@pytest.mark.parametrize("name,spatial", [
    ("VNet", (8, 8, 8)), ("VNetLegacy", (8, 8, 8)), ("UNet", (8, 8)),
    ("Dense", (4, 4, 4)), ("AttentionVNet", (8, 8, 8))])
def test_checkpoints_round_trip(name, spatial, rng):
    """flax variables -> state_dict -> flax is exact, and the port's
    state_dict goes through flax and back unchanged."""
    x = np.zeros((1,) + spatial + (1,), np.float32)
    kw = dict(SMALL, num_classes=2)
    jnet = jax_build_network(name, **kw)
    variables = random_variables(jnet, rng, jnp.asarray(x), train=False)
    sd = flax_to_state_dict(variables)
    port = build_network(name, device="cpu", spatial_rank=len(spatial),
                         patch_shape=spatial, **kw)
    port.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(port.state_dict())
    got, ref = dict(_flat(back)), dict(_flat(variables))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=str(key))
    again = flax_to_state_dict(back)
    for key, value in port.state_dict().items():
        assert torch.equal(again[key], value), key


def test_build_network_names_and_warnings():
    assert set(NETWORKS) == {"VNet", "VNetLegacy", "UNet", "Dense",
                             "AttentionVNet", "SwinUNETR"}
    with pytest.raises(NotImplementedError):
        build_network("FCN", num_classes=2, device="cpu")
    with pytest.raises(NotImplementedError):
        build_network("AttentionVNet", num_classes=2, device="cpu",
                      spatial_rank=2)
    with pytest.raises(ValueError, match="Invalid network"):
        build_network("ResNet", num_classes=2, device="cpu")
    with pytest.warns(UserWarning, match="UNet does not implement "
                      "DropoutImpl, DwImpl, Remat"):
        build_network("UNet", num_classes=2, device="cpu", num_levels=1,
                      dropout_impl="pallas", dw_impl="pallas", remat=True)
    with pytest.warns(UserWarning, match="Dense does not implement Remat"):
        build_network("Dense", num_classes=2, device="cpu", remat=True,
                      patch_shape=(4, 4, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in ("VNet", "VNetLegacy", "AttentionVNet"):
            remat = build_network(name, num_classes=2, device="cpu",
                                  num_levels=1, num_convolutions=(1,),
                                  remat=True)
            assert remat.remat
        assert remat.vnet.remat
        net = build_network("VNetLegacy", num_classes=2, device="cpu")
    assert net.conv_impl == "packed" and net.packed_target_lanes == 128
    assert hasattr(net.encoder_level_1, "pre_norm_1")


# ---------------------------------------------------------------------------
# the training CLI on the CPU for each new name

PATCH = (16, 16, 16)


def _write_config(tmp, name, **networks):
    crop = {"output_size": list(PATCH)}
    norm = {"name": "ManualNormalization",
            "variables": {"windowMin": 0, "windowMax": 200}}
    pipeline = {"preprocess": {
        "train": {"3D": [norm, {"name": "Padding", "variables": crop},
                         {"name": "RandomCrop",
                          "variables": dict(crop, drop_ratio=0.5,
                                            min_pixel=1)}]},
        "evaluate": {"3D": [norm, {"name": "Padding", "variables": crop}]}}}
    (tmp / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    tree = {
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": str(tmp / "training"),
                     "TestingDataDirectory": str(tmp / "training")},
            "Restore": False, "SegmentationClasses": [0, 1],
            "LogDir": str(tmp / "log"), "CheckpointDir": str(tmp / "ckpt"),
            "BatchSize": 2, "PatchShape": list(PATCH), "Testing": False,
            "MaxIterations": 2, "LogInterval": 1, "LoaderWorkers": 0,
            "Networks": dict({"Name": name, "Dropout": 0.1, "NumChannel": 4,
                              "NumLevels": 2, "NumConvolutions": [1, 2],
                              "BottomConvolutions": 1, "Norm": "batch"},
                             **networks),
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


@pytest.mark.parametrize("name,networks", [
    ("UNet", {}), ("Dense", {}),
    ("VNetLegacy", {"DropoutImpl": "pallas", "DwImpl": "pallas"})])
def test_cli_trains_and_evaluates(name, networks, tmp_path):
    make_dataset_dir(str(tmp_path), "training", num_cases=2,
                     rng=np.random.default_rng(1))
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1,
                     rng=np.random.default_rng(2))
    cfg = _write_config(tmp_path, name, **networks)
    state = main(["-p", "train", "--config_json", cfg, "--device", "cpu"])
    assert state.step == 2
    with open(tmp_path / "log" / "train" / "scalars.jsonl") as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"loss/0.total_loss"' in line]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    saved = checkpoints.restore_latest_state(str(tmp_path / "ckpt"))
    assert saved["step"] == 2
    with open(tmp_path / "ckpt" / "network_config.json") as f:
        assert json.load(f)["Networks"]["Name"] == name
    results = main(["-p", "evaluate", "--config_json", cfg,
                    "--device", "cpu"])
    assert len(results) == 1 and os.path.exists(results[0])
