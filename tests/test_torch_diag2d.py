"""The port's 2D quality probes (``vnet_tpu_torch/experiments/diag2d/``)
against the JAX scripts of ``scripts/experiments/diag2d/``, on the CPU.

The workdir is ``<tmp>/tmp/quality2d``, the path three of the JAX scripts
hard-code, so they run from ``<tmp>``: three ``make_hard_case`` cases of
32x32x64 (two training, one evaluation; contrast 2.0, the 2D recipe's)
under the port quickstart's small 2D config and pipeline (a 2D V-Net of 4
channels and 2 levels, float32, dropout 0) at ``DropRatio`` 1.0, so the
slice inventory holds all 128 training slices. JAX's ``Trainer`` takes
one step from the port's seeded weights (flax's op-by-op init compiles for
a minute on the CPU) and writes its orbax checkpoint; ``convert.py``
turns that state into the port's ``ckpt_<step>.pt``, which a copy of the
config names as its ``CheckpointPath``.

The JAX scripts are module-level scripts, run in-process by
``runpy.run_path`` from ``<tmp>`` with their ``sys.argv``, their output
captured; JAX's ``eval_apply`` runs under ``jax.jit`` meanwhile (the same
function, one program in place of an op-by-op forward). Both sides' host
generators (``data/rand.py``, which the slice inventory and the training
transforms draw from, unseeded in the scripts) are seeded alike before
each pair of runs.

Held: the oracle's lines exactly; ``oracle_dice`` at one contrast and one
case equal to JAX's; each probe's lines, text equal and every number
within one unit of its last printed digit of JAX's (float32 on both sides
in other summation orders: a rounding or an argmax near-tie may fall
the other way); ``probe2d_r5b``'s train-mode forward leaves the network's
running averages bitwise as they were.
"""

import importlib.util
import json
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu import models as jax_models
from vnet_tpu.config import load_config as jax_load_config
from vnet_tpu.data import rand as jax_rand
from vnet_tpu.parallel.mesh import replicated
from vnet_tpu.train import Trainer as JaxTrainer
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu_torch import quickstart
from vnet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from vnet_tpu_torch.data import rand as port_rand
from vnet_tpu_torch.experiments.diag2d import (oracle2d_r5, oracle2d_sweep,
                                               probe2d_r5, probe2d_r5b,
                                               probe2d_r5c, restore,
                                               samples, train_dataset)
from vnet_tpu_torch.io import MedicalImage, write_image
from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.train import checkpoints
from vnet_tpu_torch.utils.synthdata import make_hard_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG = os.path.join(REPO, "scripts", "experiments", "diag2d")
SHAPE = (32, 32, 64)
PATCH = (32, 32)
NUM = re.compile(r"-?\d+(?:\.\d+)?")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_initial_state(seed=0):
    """JAX ``Trainer.init_state`` from the port's seeded 2D weights (the
    same tree, so training, checkpointing and restoring run as they do)."""
    net = build_network("VNet", num_classes=3, num_channels=4, num_levels=2,
                        num_convolutions=(1, 1), bottom_convolutions=1,
                        dropout_rate=0.0, spatial_rank=2, device="cpu",
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
    """``(root, JAX workdir, port workdir)``; while the module's tests run,
    JAX's ``Trainer.init_state`` is ``_port_initial_state``'s and its
    ``eval_apply`` runs under ``jax.jit``."""
    root = tmp_path_factory.mktemp("diag2d")
    wd = root / "tmp" / "quality2d"
    wd.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for split, n in (("training", 2), ("testing", 1), ("evaluate", 1)):
        make_hard_dataset(str(wd), split, n, rng, shape=SHAPE, contrast=2.0)
    cpath = quickstart.write_config(str(wd), PATCH, steps=1, small=True,
                                    drop_ratio=1.0, min_pixel=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "init_state", _port_initial_state())
        mp.setattr(jax_models, "eval_apply",
                   jax.jit(jax_models.eval_apply, static_argnums=0))
        jax_rand.seed(0)
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
        yield root, str(wd), str(port_wd)


def _run_jax(script, root, argv, capsys, monkeypatch, seed=0):
    """Output lines of a JAX script run from ``root``."""
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "argv", [script] + argv)
    capsys.readouterr()
    jax_rand.seed(seed)
    runpy.run_path(os.path.join(DIAG, script), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def _run_port(module, argv, capsys, seed=0):
    capsys.readouterr()
    port_rand.seed(seed)
    assert module.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _close(got, ref):
    """Lines equal but for numbers, each within one unit of the last
    digit JAX printed."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert NUM.sub("#", g) == NUM.sub("#", r), (g, r)
        for a, b in zip(NUM.findall(g), NUM.findall(r)):
            places = len(b.partition(".")[2])
            assert abs(float(a) - float(b)) <= 1.0001 * 10.0 ** -places, (
                g, r)


def test_oracle_prints_the_jax_lines(workdirs, capsys, monkeypatch):
    root, wd, _ = workdirs
    ref = _run_jax("oracle2d_r5.py", root, [], capsys, monkeypatch)
    got = _run_port(oracle2d_r5, ["--workdir", wd], capsys)
    assert ref[0].startswith("oracle pooled dice: class1 ")
    assert ref[1].startswith("case_0: oracle dice [")
    assert got == ref


def test_oracle_stops_where_no_threshold_scores(tmp_path):
    """A case with no foreground: no threshold gives class 1 a Dice above
    0 (the JAX script fails on its ``None`` threshold)."""
    case = tmp_path / "evaluate" / "case_0"
    case.mkdir(parents=True)
    img = np.random.default_rng(0).normal(100, 20, (32, 32, 4))
    write_image(MedicalImage(img.astype(np.float32), (1.0, 1.0, 1.0)),
                str(case / "image.nii"))
    write_image(MedicalImage(np.zeros((32, 32, 4), np.uint8),
                             (1.0, 1.0, 1.0)), str(case / "label.nii"))
    with pytest.raises(SystemExit, match="gives class 1 a Dice above 0"):
        oracle2d_r5.main(["--workdir", str(tmp_path)])


def test_oracle_sweep_matches_jax():
    spec = importlib.util.spec_from_file_location(
        "oracle2d_sweep_jax", os.path.join(DIAG, "oracle2d_sweep.py"))
    jax_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_sweep)
    ref = jax_sweep.oracle_dice(2.0, n_cases=1)
    got = oracle2d_sweep.oracle_dice(2.0, n_cases=1)
    assert got == [tuple(x) for x in ref]
    assert all(d > 0 for d, _ in got)


def test_oracle_sweep_prints_a_line_a_contrast(capsys):
    assert oracle2d_sweep.main(["--contrasts", "3.0", "--n-cases",
                                "1"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    (d1, t1), (d2, t2) = oracle2d_sweep.oracle_dice(3.0, n_cases=1)
    assert line == (f"contrast 3.0: oracle pooled dice class1 {d1:.3f} "
                    f"@thr {t1}, class2 {d2:.3f} @thr {t2}")


@pytest.mark.parametrize("script,module,shape", [
    ("probe2d_r5.py", probe2d_r5, ["A ", "B ", "C ", "C1"]),
    ("probe2d_r5b.py", probe2d_r5b, ["eval_apply", "train-mode"]),
    ("probe2d_r5c.py", probe2d_r5c,
     ["A ", "A ", "A ", "A2", "A2", "A2", "A2", "B ", "B ", "B ", "B ",
      "D ", "D ", "D ", "E "]),
])
def test_probe_prints_the_jax_lines(workdirs, capsys, monkeypatch, script,
                                    module, shape):
    root, wd, port_wd = workdirs
    argv = ([wd] if script == "probe2d_r5c.py" else [])
    ref = _run_jax(script, root, argv, capsys, monkeypatch)
    ref = [x for x in ref if x[:2] in {s[:2] for s in shape}]
    assert [x[:2] for x in ref] == [s[:2] for s in shape], ref
    workdir = (["--workdir", port_wd] if script != "probe2d_r5c.py"
               else [port_wd])
    got = _run_port(module, workdir + ["--device", "cpu"], capsys)
    _close(got, ref)


def test_train_mode_forward_keeps_the_running_averages(workdirs):
    _, _, port_wd = workdirs
    cfg, ev = restore(port_wd, "cpu")
    port_rand.seed(0)
    imgs, _ = samples(train_dataset(cfg), range(8))
    x = torch.from_numpy(np.stack(imgs))
    net = probe2d_r5b.train_network(cfg, "cpu")
    net.load_state_dict(ev.network.state_dict())
    before = {k: b.clone() for k, b in net.named_buffers()}
    out = probe2d_r5b.train_mode_forward(net, x, 0)
    assert not net.training and out.shape == (8, *PATCH, 3)
    for k, b in net.named_buffers():
        assert torch.equal(b, before[k]), k
    net.train()
    with torch.no_grad():
        net(x, dropout_seed=0)
    assert any(not torch.equal(b, before[k])
               for k, b in net.named_buffers()), "train mode moved nothing"
