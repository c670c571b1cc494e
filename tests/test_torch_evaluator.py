"""The slice as a whole: the port's Evaluator against the JAX Evaluator.

The JAX Evaluator sees one device (``jax.devices`` patched, as in
``tests/test_evaluator.py``), so ``BlendImpl: auto`` resolves to its Pallas
blend, run in interpret mode; the port's Evaluator runs on the CPU, where
the blend takes its plain version. Same case (stride < patch, so patches
overlap; LCC and volume threshold on), same weights. The JAX network runs
the space-to-depth convolutions and the port direct ones, so probabilities
compare at ``atol = 1e-4`` and labels, which can only differ at argmax
ties, must agree on at least 99.9% of voxels.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_dataset_dir
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.infer import Evaluator as JaxEvaluator
from vnet_tpu.infer import postprocess as jpost
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu_torch.__main__ import main
from vnet_tpu_torch.config import load_config
from vnet_tpu_torch.convert import flax_to_state_dict
from vnet_tpu_torch.infer import postprocess as tpost
from vnet_tpu_torch.infer.evaluator import Evaluator
from vnet_tpu_torch.io import MedicalImage, read_image
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.train import checkpoints

from torch_parity import random_variables

PATCH, STRIDE = (16, 16, 16), (8, 8, 8)
NET = {"Name": "VNet", "NumChannel": 4, "NumLevels": 2,
       "NumConvolutions": [1, 2], "BottomConvolutions": 1}


def _write_config(tmp_path, norm, eval_norm="network", label_mode="argmax",
                  mask_probs=False, blend="auto", attention=False):
    pipeline = {"preprocess": {"evaluate": {"3D": [
        {"name": "ManualNormalization",
         "variables": {"windowMin": 0, "windowMax": 200}},
        {"name": "Padding", "variables": {"output_size": list(PATCH)}}]}}}
    ppath = tmp_path / "pipeline.yaml"
    ppath.write_text(yaml.safe_dump(pipeline))
    tree = {
        "TrainingSetting": {
            "SegmentationClasses": [0, 1, 2], "PatchShape": list(PATCH),
            "CheckpointDir": str(tmp_path / "ckpt"), "Pipeline": str(ppath),
            "Precision": "float32",
            "Networks": dict(NET, Norm=norm, Attention=attention)},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": str(tmp_path / "evaluate"),
                     "ImageFilenames": ["image.nii"],
                     "LabelFilename": "label_port.nii.gz",
                     "ProbabilityFilename": "prob_port.nii.gz"},
            "CheckpointPath": str(tmp_path / "ckpt"), "Stride": list(STRIDE),
            "BatchSize": 3, "ProbabilityOutput": True,
            "LargestConnectedComponent": True, "VolumeThreshold": 20,
            "GaussianBlend": True, "EvalNorm": eval_norm,
            "LabelMode": label_mode, "MaskProbabilityWithLabel": mask_probs,
            "BlendImpl": blend}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _weights(norm, rng):
    net = jax_build_network("VNet", num_classes=3, num_channels=4,
                            num_levels=2, num_convolutions=(1, 2),
                            bottom_convolutions=1, norm=norm)
    return random_variables(net, rng, jnp.zeros((1,) + PATCH + (1,)),
                            train=False)


@pytest.mark.parametrize("norm,eval_norm,label_mode,mask_probs", [
    ("batch_stats", "network", "argmax", False),
    ("batch", "network", "argmax", False),
    ("batch_stats", "ema", "average_hard", True),
])
def test_evaluator_matches_jax(norm, eval_norm, label_mode, mask_probs,
                               tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=1, rng=rng)
    case = str(tmp_path / "evaluate" / "case_0")
    cfg_path = _write_config(tmp_path, norm, eval_norm, label_mode,
                             mask_probs)
    cfg = load_config(cfg_path)
    variables = _weights(norm, rng)

    dev0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
    jev = JaxEvaluator(jax_load_config(cfg_path), state=types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    assert jev.engine.blend_impl == "pallas"
    ref_label, ref_probs = jev.evaluate_case(case)

    ev = Evaluator(cfg, state_dict=flax_to_state_dict(variables),
                   device="cpu")
    label, probs = ev.evaluate_case(case)

    assert label.GetSize() == ref_label.GetSize()
    agree = np.mean(np.asarray(label.data) == np.asarray(ref_label.data))
    assert agree >= 0.999, agree
    assert len(probs) == len(ref_probs) == 3
    for p, r in zip(probs, ref_probs):
        np.testing.assert_allclose(p.data, r.data, atol=1e-4, rtol=0)


def test_cli_evaluate_on_cpu_writes_outputs(tmp_path):
    rng = np.random.default_rng(3)
    make_dataset_dir(str(tmp_path), "evaluate", num_cases=2, rng=rng)
    cfg_path = _write_config(tmp_path, "batch")
    net = build_network("VNet", num_classes=3, num_channels=4, num_levels=2,
                        num_convolutions=(1, 2), bottom_convolutions=1,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    checkpoints.save(str(tmp_path / "ckpt"), net.state_dict(), 5)
    results = main(["-p", "evaluate", "--config_json", cfg_path,
                    "--device", "cpu"])
    assert len(results) == 2
    for r in results:
        label = read_image(r)
        src = read_image(os.path.join(os.path.dirname(r), "image.nii"))
        assert label.GetSize() == src.GetSize()
        assert set(np.unique(label.data)) <= {0, 1}
        for c in range(3):
            prob = read_image(os.path.join(os.path.dirname(r),
                                           f"prob_port_{c}.nii.gz"))
            assert np.isfinite(prob.data).all()


def test_cli_train_is_not_ported(tmp_path):
    """Training is ported for the V-Net; attention networks still raise."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["-p", "train", "--config_json",
              _write_config(tmp_path, "batch", attention=True),
              "--device", "cpu"])


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = load_config(_write_config(tmp_path, "batch"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(cfg, device="cuda")


def test_eval_norm_without_batch_norm_warns(tmp_path):
    cfg = load_config(_write_config(tmp_path, "group", eval_norm="ema"))
    net = build_network("VNet", num_classes=3, num_channels=4, num_levels=2,
                        num_convolutions=(1, 2), bottom_convolutions=1,
                        norm="group", device="cpu")
    with pytest.warns(UserWarning, match="no effect"):
        Evaluator(cfg, state_dict=net.state_dict(), device="cpu")


def test_missing_checkpoint_raises(tmp_path):
    cfg = load_config(_write_config(tmp_path, "batch"))
    with pytest.raises(FileNotFoundError, match="ckpt_"):
        Evaluator(cfg, device="cpu")


def test_checkpoint_restores_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    assert checkpoints.restore_latest(d) is None
    checkpoints.save(d, {"w": torch.zeros(2)}, 3)
    checkpoints.save(d, {"w": torch.ones(2)}, 12)
    checkpoints.save(d, {"w": torch.full((2,), 2.0)}, 7)
    assert checkpoints.latest_step(d) == 12
    torch.testing.assert_close(checkpoints.restore_latest(d)["w"],
                               torch.ones(2))


@pytest.mark.parametrize("fn", ["extract_largest_connected_component",
                                "volume_threshold"])
def test_postprocess_copy_matches_jax_package(fn, rng):
    data = (rng.random((12, 10, 8)) > 0.6).astype(np.uint8)
    img = MedicalImage(data, (1.0, 1.0, 1.5))
    args = (4.0,) if fn == "volume_threshold" else ()
    np.testing.assert_array_equal(getattr(tpost, fn)(img, *args).data,
                                  getattr(jpost, fn)(img, *args).data)
