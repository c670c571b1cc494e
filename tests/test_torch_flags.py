"""The port's flag command lines (``vnet_tpu_torch/flags``) against the
repo's ``train.py`` and ``evaluate.py``: the same argv gives the same
``Config`` fields and the same generated pipeline; a tiny ``flags.train
--attention`` run on the CPU feeds ``flags.evaluate`` and the port's
``batch_evaluate``. Also the CLI's rank count under ``--devices 0``
(``vnet_tpu_torch/__main__.py::_ranks``) with the card count patched to 4:
training takes ``Mesh.DataParallel`` ranks as the JAX trainer sizes its
mesh, and refuses more than there are cards.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import evaluate as jevaluate  # noqa: E402
import train as jtrain  # noqa: E402
from fixtures import make_dataset_dir  # noqa: E402
from vnet_tpu_torch import __main__ as cli  # noqa: E402
from vnet_tpu_torch.config import TrainingConfig  # noqa: E402
from vnet_tpu_torch.flags import evaluate as tevaluate  # noqa: E402
from vnet_tpu_torch.flags import train as ttrain  # noqa: E402

# the argv cases of tests/test_cli.py, and the attention quality run's
TRAIN_ARGV = {
    "attention_jaccard": [
        "--batch_size", "2", "--patch_size", "32", "--patch_layer", "16",
        "--loss_function", "jaccard", "--optimizer", "nesterov_momentum",
        "--momentum", "0.8", "--attention"],
    "save_interval": ["--save_interval", "50"],
    "defaults": [],
    "legacy_topology": ["--legacy_topology"],
    "memory_flags": ["--attention", "--dropout_impl", "bits8", "--remat"],
    "attn_quality": [
        "--attention", "--batch_size", "8", "--patch_size", "64",
        "--patch_layer", "64", "--max_iterations", "3000", "--optimizer",
        "adam", "--init_learning_rate", "1e-3", "--loss_function",
        "sorensen", "--attention_loss_function", "l2", "--drop_ratio", "0.3",
        "--min_pixel", "32", "--dropout_impl", "bits8", "--cache_cases",
        "64", "--device_augment", "--display_step", "50", "--save_interval",
        "20", "--testing", "--image_log", "--no_restore_training"],
}
EVAL_ARGV = {
    "strides": ["--stride_inplane", "96", "--stride_layer", "8",
                "--attention", "--gaussian_blend"],
    "defaults": [],
    "legacy_eval": ["--probability_output", "--volume_threshold", "50",
                    "--label_mode", "argmax", "--eval_norm", "batch_stats",
                    "--batch_size", "3", "--label_filename", "pred.nii.gz"],
}


def _same_config(t, j):
    assert dataclasses.asdict(t.train) == dataclasses.asdict(j.train)
    assert dataclasses.asdict(t.evaluate) == dataclasses.asdict(j.evaluate)


def _pipelines(t, j):
    with open(t.train.pipeline_path) as a, open(j.train.pipeline_path) as b:
        return yaml.safe_load(a), yaml.safe_load(b)


def _without_pipelines(cfg):
    """The config with its (generated, temporary) pipeline paths blanked."""
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, pipeline_path=""),
        evaluate=dataclasses.replace(cfg.evaluate, pipeline_path=""))


@pytest.mark.parametrize("case", sorted(TRAIN_ARGV))
def test_train_flags_to_config_equal_jax(tmp_path, case):
    argv = ["--data_dir", str(tmp_path), "--log_dir",
            str(tmp_path / "log"), "--checkpoint_dir",
            str(tmp_path / "ckpt")] + TRAIN_ARGV[case]
    t = ttrain.flags_to_config(ttrain.get_parser().parse_args(argv))
    j = jtrain.flags_to_config(jtrain.get_parser().parse_args(argv))
    _same_config(_without_pipelines(t), _without_pipelines(j))
    a, b = _pipelines(t, j)
    assert a == b
    assert t.train.pipeline_path != j.train.pipeline_path
    # as tests/test_cli.py: the generated pipeline is not under the log dir
    assert not os.path.abspath(t.train.pipeline_path).startswith(
        os.path.abspath(str(tmp_path / "log")))
    from vnet_tpu_torch.data import build_pipeline
    assert [x.name for x in build_pipeline(a, "train", 3)] == [
        "Padding", "Random Crop"]


@pytest.mark.parametrize("attention", [False, True])
def test_remat_flag_reaches_the_network(tmp_path, attention):
    """``--remat`` sets ``Networks.Remat`` and the trainer builds the
    network with it (the attention network's backbone too), warning about
    nothing."""
    import warnings

    from vnet_tpu_torch.train import Trainer

    argv = ["--data_dir", str(tmp_path), "--log_dir", str(tmp_path / "log"),
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--remat",
            "--device", "cpu"] + (["--attention"] if attention else [])
    config = ttrain.flags_to_config(ttrain.get_parser().parse_args(argv))
    assert config.train.network.remat
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        net = Trainer(config, device="cpu", log=False).network
    assert net.remat and (not attention or net.vnet.remat)


def test_train_flags_with_a_pipeline_and_split_dirs(tmp_path):
    (tmp_path / "training").mkdir()
    pipeline = tmp_path / "p.yaml"
    pipeline.write_text("preprocess: {}\n")
    argv = ["--data_dir", str(tmp_path), "--pipeline", str(pipeline),
            "--attention"]
    t = ttrain.flags_to_config(ttrain.get_parser().parse_args(argv))
    j = jtrain.flags_to_config(jtrain.get_parser().parse_args(argv))
    _same_config(t, j)
    assert t.train.data_dir == str(tmp_path / "training")
    assert t.train.network.norm == "batch"


@pytest.mark.parametrize("sidecar", [None, {"Networks": {
    "Name": "VNetLegacy", "NumChannel": 8, "NumLevels": 3,
    "NumConvolutions": [1, 2, 2], "BottomConvolutions": 2,
    "Attention": False, "Norm": "batch_stats"},
    "SegmentationClasses": [0, 1, 2], "Precision": "bfloat16"},
    {"Networks": {"Name": "VNet", "Attention": True},
     "SegmentationClasses": [0, 1]}])
@pytest.mark.parametrize("case", sorted(EVAL_ARGV))
def test_evaluate_flags_to_config_equal_jax(tmp_path, case, sidecar):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    if sidecar is not None:
        import json
        (ckpt / "network_config.json").write_text(json.dumps(sidecar))
    argv = ["--data_dir", str(tmp_path), "--checkpoint_path",
            str(ckpt)] + EVAL_ARGV[case]
    t = tevaluate.flags_to_config(tevaluate.get_parser().parse_args(argv))
    j = jevaluate.flags_to_config(jevaluate.get_parser().parse_args(argv))
    _same_config(_without_pipelines(t), _without_pipelines(j))
    a, b = _pipelines(t, j)
    assert a == b


def test_flags_default_to_the_card():
    for mod in (ttrain, tevaluate):
        assert mod.get_parser().parse_args([]).device == "cuda"


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks the refusal where torch sees no card")
def test_flags_raise_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--data_dir", str(tmp_path), "--max_iterations", "1"])


def test_attention_flags_train_then_evaluate_on_cpu(tmp_path):
    """One ``--attention --dropout_impl bits8`` step at a 16^3 patch; its
    checkpoint and sidecar feed ``flags.evaluate`` (both modes) and the
    port's ``batch_evaluate`` command line."""
    rng = np.random.default_rng(0)
    data = str(tmp_path / "data")
    make_dataset_dir(data, "training", 2, rng, shape=(20, 20, 16))
    # held-out cases with labels, for the grid search's scores
    make_dataset_dir(data, "held_out", 1, rng, shape=(20, 20, 16))
    ckpt = str(tmp_path / "ckpt")
    state = ttrain.main([
        "--attention", "--dropout_impl", "bits8", "--device_augment",
        "--data_dir", data, "--batch_size", "1", "--patch_size", "16",
        "--patch_layer", "16", "--max_iterations", "1", "--optimizer",
        "adam", "--loss_function", "sorensen", "--drop_ratio", "1.0",
        "--min_pixel", "0", "--log_dir", str(tmp_path / "log"),
        "--checkpoint_dir", ckpt, "--device", "cpu"])
    assert state.step == 1
    assert type(state.network).__name__ == "AttentionGatedVNet"
    assert os.path.exists(os.path.join(ckpt, "network_config.json"))
    case = os.path.join(data, "held_out", "case_0")
    for mode in ("ema", "batch_stats"):
        paths = tevaluate.main([
            "--attention", "--data_dir", os.path.join(data, "held_out"),
            "--checkpoint_path", ckpt, "--patch_size", "16",
            "--patch_layer", "16", "--stride_inplane", "8",
            "--stride_layer", "8", "--batch_size", "4", "--eval_norm", mode,
            "--label_filename", f"pred_{mode}.nii.gz", "--device", "cpu"])
        assert paths == [os.path.join(case, f"pred_{mode}.nii.gz")]
        from vnet_tpu_torch.io import read_image
        label = read_image(paths[0])
        assert label.GetSize() == (20, 20, 16)
        assert set(np.unique(label.data)) <= {0, 1}

    from vnet_tpu_torch.utils.batch_evaluate import main as be_main
    cfg = tmp_path / "be.json"
    pipeline = tmp_path / "eval.yaml"
    pipeline.write_text(yaml.safe_dump({"preprocess": {"evaluate": {"3D": [
        {"name": "Padding", "variables": {"output_size": [16, 16, 16]}}]}}}))
    import json
    cfg.write_text(json.dumps({
        "TrainingSetting": {
            "Data": {"TrainingDataDirectory": data,
                     "TestingDataDirectory": data},
            "PatchShape": [16, 16, 16], "SegmentationClasses": [0, 1],
            "Networks": {"Attention": True, "Norm": "batch"}},
        "EvaluationSetting": {
            "Data": {"EvaluateDataDirectory": os.path.join(data, "held_out"),
                     "LabelFilename": "pred_grid.nii.gz"},
            "CheckpointPath": ckpt, "BatchSize": 4,
            "Pipeline": str(pipeline)}}))
    results = be_main(["--config_json", str(cfg), "--stride_inplane", "8",
                       "16", "--stride_layer", "8", "--modes", "DICE",
                       "ITEM", "--csv", str(tmp_path / "grid.csv"),
                       "--device", "cpu"])
    assert [(r.stride_inplane, r.stride_layer) for r in results] == [
        (8, 8), (16, 8)]
    for r in results:
        assert set(r.per_case) == {"case_0"}
        assert 0.0 <= r.per_case["case_0"]["DICE"] <= 1.0
    assert "MEAN" in (tmp_path / "grid.csv").read_text()


# --- the CLI's ranks under --devices 0 (four cards patched in) --------------

def _args(devices=0, phase="train", device="cuda"):
    return argparse.Namespace(devices=devices, phase=phase, device=device)


@pytest.fixture
def four_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("batch,dp,dcn,devices,phase,want", [
    (32, 2, 0, 0, "train", 2),      # Mesh.DataParallel 2 of 4 cards
    (32, 4, 0, 0, "train", 4),
    (32, 0, 0, 0, "train", 4),      # 0: gcd(BatchSize, cards)
    (6, 0, 0, 0, "train", 2),
    (7, 0, 0, 0, "train", 1),
    (32, 2, 0, 3, "train", 3),      # --devices N wins over the config
    (32, 8, 0, 1, "train", 1),
    (32, 2, 0, 0, "evaluate", 4),   # evaluation: every card
    (32, 8, 0, 0, "evaluate", 4),
    (32, 2, 0, 2, "evaluate", 2),
    (32, 2, 2, 0, "train", 2),      # DcnDataParallel: the node's ICI part
    (32, 0, 2, 0, "train", 4),      # ... every card for 0
    (32, 2, 1, 0, "train", 2),      # DcnDataParallel 1: one node
])
def test_ranks_follow_mesh_data_parallel(four_cards, batch, dp, dcn, devices,
                                         phase, want):
    t = TrainingConfig(batch_size=batch, mesh_data_parallel=dp,
                       mesh_dcn_parallel=dcn)
    assert cli._ranks(_args(devices, phase), t) == want


@pytest.mark.parametrize("dp,dcn,devices,match", [
    (8, 0, 0, "Mesh.DataParallel 8 needs 8 cards"),
    (5, 2, 0, "Mesh.DataParallel 5 needs 5 cards"),
    (2, 0, 5, "--devices 5 needs 5 cards"),
])
def test_ranks_refuse_more_than_the_cards(four_cards, dp, dcn, devices,
                                          match):
    t = TrainingConfig(batch_size=32, mesh_data_parallel=dp,
                       mesh_dcn_parallel=dcn)
    with pytest.raises(ValueError, match=match):
        cli._ranks(_args(devices), t)


@pytest.mark.parametrize("dp,devices,want", [(2, 0, 1), (0, 0, 1),
                                             (2, 3, 3)])
def test_ranks_on_the_cpu_are_unchanged(dp, devices, want):
    t = TrainingConfig(batch_size=32, mesh_data_parallel=dp)
    assert cli._ranks(_args(devices, device="cpu"), t) == want


def test_attn_quality_steps_equal_jax(tmp_path, monkeypatch):
    """``experiments/attn_quality.py`` against the JAX script: the same
    dataset files, ``pipeline.yaml`` and training flags (the JAX ``train.py``
    and the port's flag CLI reach equal configs from them), and the same
    two evaluations; subprocesses recorded, not run."""
    import importlib.util
    import subprocess

    from vnet_tpu_torch.experiments import attn_quality as tattn

    spec = importlib.util.spec_from_file_location(
        "jattn_quality", os.path.join(os.path.dirname(jtrain.__file__),
                                      "scripts", "experiments",
                                      "attn_quality.py"))
    jattn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jattn)
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda args, **kw: calls.append(list(args)))
    runs = {}
    for name, mod in (("jax", jattn), ("port", tattn)):
        calls.clear()
        wd = str(tmp_path / name)
        argv = ["--workdir", wd, "--small", "--steps", "3", "--train-only"]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
        runs[name] = (wd, [c[2:] if c[1] == "-m" else c[1:] for c in calls])
    (jwd, jcalls), (twd, tcalls) = runs["jax"], runs["port"]
    with open(os.path.join(jwd, "pipeline.yaml")) as a, open(
            os.path.join(twd, "pipeline.yaml")) as b:
        assert yaml.safe_load(a) == yaml.safe_load(b)
    for d, _, files in os.walk(jwd):
        for f in files:
            if f.endswith(".nii"):
                mine = os.path.join(twd, os.path.relpath(os.path.join(d, f),
                                                         jwd))
                with open(os.path.join(d, f), "rb") as a, open(mine,
                                                               "rb") as b:
                    assert a.read() == b.read(), mine
    assert len(jcalls) == len(tcalls) == 1
    jargv, targv = jcalls[0][1:], tcalls[0][1:]  # past the script / module
    assert jcalls[0][0] == "train.py"
    assert tcalls[0][0] == "vnet_tpu_torch.flags.train"
    assert targv[-2:] == ["--device", "cpu"]
    targv = [a.replace(twd, jwd) for a in targv[:-2]]
    assert targv == jargv
    t = ttrain.flags_to_config(ttrain.get_parser().parse_args(targv))
    j = jtrain.flags_to_config(jtrain.get_parser().parse_args(jargv))
    _same_config(t, j)

    # the two evaluations: the same flags, each mode into its own file
    eval_argv = {}
    for name, mod in (("jax", jattn), ("port", tattn)):
        calls.clear()
        wd = str(tmp_path / name)
        with pytest.raises(FileNotFoundError):  # no predictions written
            mod.main(["--workdir", wd, "--small", "--steps", "3"]
                     + (["--device", "cpu"] if name == "port" else []))
        eval_argv[name] = [c[2:] if c[1] == "-m" else c[1:]
                           for c in calls[1:]]
    assert [c[0] for c in eval_argv["jax"]] == ["evaluate.py"] * 2
    assert [c[0] for c in eval_argv["port"]] == [
        "vnet_tpu_torch.flags.evaluate"] * 2
    for jc, tc in zip(eval_argv["jax"], eval_argv["port"]):
        assert tc[-2:] == ["--device", "cpu"]
        assert [a.replace(str(tmp_path / "port"), str(tmp_path / "jax"))
                for a in tc[1:-2]] == jc[1:]


# --- the LiTS rehearsal and the attention step ladder (CPU smoke modes) -----

@pytest.fixture
def one_thread():
    """Tiny networks: one intra-op thread, so that the tests' time does not
    grow with the other test processes' threads."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_lits_rehearsal_small_trains_and_evaluates_on_cpu(tmp_path, capsys,
                                                          one_thread):
    """``--small``: the JAX script's tiny chain on the CPU, its lines."""
    from vnet_tpu_torch.experiments import lits_rehearsal

    wd = tmp_path / "lits"
    assert lits_rehearsal.main(["--small", "--steps", "2", "--workdir",
                                str(wd)]) == 0
    out = capsys.readouterr().out
    assert "LITS-REHEARSAL train: 2 steps of b2 (48, 48, 16) patches" in out
    assert "LITS-REHEARSAL eval: 1 case(s) at stride (48, 48, 16)" in out
    assert "case_0: dice per class [" in out
    assert (wd / "evaluate" / "case_0" / "pred.nii.gz").exists()
    written = json.loads((wd / "config.json").read_text())
    assert "Remat" not in written["TrainingSetting"]["Networks"]
    full = lits_rehearsal.write_config(str(tmp_path), False, 200, 32)
    ts = json.loads(open(full).read())["TrainingSetting"]
    assert (ts["PatchShape"], ts["BatchSize"], ts["Precision"]) == (
        [256, 256, 32], 32, "bfloat16")


def test_attention_step_ladder_records_each_config(tmp_path, monkeypatch,
                                                   one_thread):
    """``--smoke`` measures 16^3 at batch 1 without and with ``Remat`` on
    the CPU; a second call skips what the log holds; a configuration that
    does not fit is recorded with its failure and the ladder goes on."""
    import torch

    from vnet_tpu_torch.experiments import attention_step

    log = tmp_path / "attn.log"
    argv = ["--log", str(log), "--smoke", "--reps", "1"]
    assert attention_step.main(argv) == 0
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [(r["exp"], r["remat"], r["device"]) for r in recs] == [
        ("attn_smoke", False, "cpu"), ("attn_smoke_remat", True, "cpu")]
    assert all(r["patches_per_s"] > 0 for r in recs)
    assert attention_step.main(argv) == 0
    assert len(log.read_text().splitlines()) == 2

    def measure(side, batch, remat, reps, device, network):
        if not remat:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"patches_per_s": 1.0, "batch": batch, "side": side,
                "remat": remat}

    monkeypatch.setattr(attention_step, "measure", measure)
    log2 = tmp_path / "ladder.log"
    assert attention_step.main(["--log", str(log2), "--smoke"]) == 0
    recs = [json.loads(line) for line in log2.read_text().splitlines()]
    assert recs[0]["error"].startswith("OutOfMemoryError")
    assert recs[1]["patches_per_s"] == 1.0
    assert [c[0] for c in attention_step._configs(False)] == [
        "attn_s64_b8_remat", "attn_s64_b16_remat", "attn_s48_b8",
        "attn_s48_b8_remat", "attn_s64_b8"]
