"""The port's evaluation diagnostics (``experiments/eval_only.py``,
``compare_preds.py``, ``patch_diagnose.py``) against the JAX scripts of
``scripts/experiments/`` on one tiny workdir, on the CPU.

The workdir is ``tests/test_trainer.py``'s: JAX's ``Trainer`` at
``max_iterations=1`` (as ``tests/test_checkpoint_compat.py`` trains it,
float32), its state converted (``convert.py``) into a port
``ckpt_<step>.pt``; the JAX scripts read the JAX workdir's
``config.json`` and orbax checkpoint, the port's a copy of that config
whose ``CheckpointPath`` names the port checkpoint. Both evaluate the
training cases (``--data-dir``, which hold ``label.nii``):

* ``eval_only`` with each blend: the same header and per-case Dice lines;
* ``patch_diagnose`` on one case: the same volume line, per-patch starts,
  Dice and prediction histograms, and the same blended Dice;
* ``compare_preds`` over the two runs' predictions (``--suffix``), the
  labels against themselves and against a disagreeing tolerance: the same
  lines and exit codes, 1 where no case holds both files.
"""

import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_trainer import write_config
from vnet_tpu import models as jax_models
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.parallel.mesh import replicated
from vnet_tpu.train import Trainer as JaxTrainer
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from vnet_tpu_torch.experiments import compare_preds, eval_only
from vnet_tpu_torch.experiments import patch_diagnose
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.train import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax", os.path.join(REPO, "scripts", "experiments",
                                    f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_initial_state(seed=0):
    """``Trainer.init_state`` from the port's seeded initialisers: flax's
    op-by-op ``init`` of even this network compiles ~250 programs, ~55 s
    on the CPU, once for the trainer and again for each evaluator's
    restore template. The state is the same tree, so training,
    checkpointing and restoring run as they do."""
    net = build_network("VNet", num_classes=2, num_channels=4,
                        num_levels=2, num_convolutions=(1, 1),
                        bottom_convolutions=1, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    variables = state_dict_to_flax(net.state_dict())

    def init_state(self, rng=None):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        stats = jax.tree_util.tree_map(jnp.asarray,
                                       variables["batch_stats"])
        return jax.device_put(JaxTrainState(
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
            params=params, batch_stats=stats,
            opt_state=self.tx.init(params)), replicated(self.mesh))

    return init_state


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    """``(jax workdir, port workdir, case directory)``. While the module's
    tests run, JAX's ``Trainer.init_state`` is ``_port_initial_state``'s
    and the ``eval_apply`` that ``patch_diagnose`` imports runs under
    ``jax.jit`` (the same function, one program in place of an op-by-op
    forward's ~10 s of compiles)."""
    root = tmp_path_factory.mktemp("diag")
    jax_wd = root / "jax"
    jax_wd.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "init_state", _port_initial_state())
        mp.setattr(jax_models, "eval_apply",
                   jax.jit(jax_models.eval_apply, static_argnums=0))
        cpath = write_config(jax_wd, np.random.default_rng(42),
                             max_iterations=1)
        state = JaxTrainer(jax_load_config(cpath), log=False).train()
        port_wd = root / "port"
        port_wd.mkdir()
        checkpoints.save(str(port_wd / "ckpt"), flax_to_state_dict(
            {"params": state.params, "batch_stats": state.batch_stats}),
            int(state.step))
        with open(cpath) as f:
            tree = json.load(f)
        tree["EvaluationSetting"]["CheckpointPath"] = str(port_wd / "ckpt")
        with open(port_wd / "config.json", "w") as f:
            json.dump(tree, f)
        yield str(jax_wd), str(port_wd), str(jax_wd / "training")


def _lines(out):
    return [x for x in out.splitlines()
            if x.startswith(("blend_impl=", "case_", "volume ", "patch ",
                             "blended ", "worst ", "no cases "))]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_eval_only_prints_the_jax_dice(workdirs, capsys, impl):
    jax_wd, port_wd, cases = workdirs
    common = ["--blend-impl", impl, "--data-dir", cases, "--max-cases", "2"]
    assert _jax_script("eval_only").main(
        ["--workdir", jax_wd, "--devices", "cpu", "--suffix", f"jax_{impl}",
         *common]) == 0
    ref = _lines(capsys.readouterr().out)
    assert eval_only.main(["--workdir", port_wd, "--device", "cpu",
                           "--suffix", f"port_{impl}", *common]) == 0
    got = _lines(capsys.readouterr().out)
    assert len(ref) == 3 and ref[0] == f"blend_impl={impl}: evaluated 2 " \
        "case(s)"
    assert got == ref
    for case in ("case_0", "case_1"):
        assert os.path.isfile(os.path.join(
            cases, case, f"label_out_port_{impl}.nii.gz"))


def test_compare_preds_matches_the_jax_script(workdirs, capsys):
    _, port_wd, cases = workdirs
    for impl in ("xla", "pallas"):
        if not os.path.isfile(os.path.join(cases, "case_1",
                                           f"label_out_port_{impl}.nii.gz")):
            eval_only.main(["--workdir", port_wd, "--device", "cpu",
                            "--blend-impl", impl, "--suffix",
                            f"port_{impl}", "--data-dir", cases])
    capsys.readouterr()
    jax_compare = _jax_script("compare_preds")
    runs = [  # (file a, file b, tol, exit code)
        ("label_out_port_xla.nii.gz", "label_out_port_pallas.nii.gz", None,
         0),
        ("label.nii", "label_out_port_xla.nii.gz", None, 1),
        ("label.nii", "label_out_port_xla.nii.gz", "1.0", 0),
        ("label.nii", "absent.nii.gz", None, 1),
    ]
    for a, b, tol, code in runs:
        argv = ["compare_preds", cases, a, b] + ([tol] if tol else [])
        assert jax_compare.main(argv) == code, (a, b, tol)
        ref = _lines(capsys.readouterr().out)
        assert compare_preds.main(argv) == code, (a, b, tol)
        assert _lines(capsys.readouterr().out) == ref
        assert ref


def test_patch_diagnose_matches_the_jax_script(workdirs, capsys):
    jax_wd, port_wd, cases = workdirs
    # the case relative to each workdir
    for wd in (jax_wd, port_wd):
        if not os.path.isdir(os.path.join(wd, "training")):
            shutil.copytree(cases, os.path.join(wd, "training"))
    assert _jax_script("patch_diagnose").main(
        ["--workdir", jax_wd, "--case", "training/case_0", "--devices",
         "cpu"]) == 0
    ref = _lines(capsys.readouterr().out)
    assert patch_diagnose.main(["--workdir", port_wd, "--case",
                                "training/case_0", "--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert ref[0] == "volume (24, 24, 16), 4 patches (patch (16, 16, 16), " \
        "stride (16, 16, 16))"
    assert len(ref) == 6 and ref[-1].startswith("blended (uniform) dice ")
    assert got == ref
