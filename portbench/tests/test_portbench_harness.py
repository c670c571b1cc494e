"""The harness: every piece found by name, the result line's keys, no JAX
in a run's process, a reference that imports nothing of the port, and the
refusals (no card, a checkout without the program)."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import run as harness
from portbench import spec
from portbench.outcome import Outcome
from portbench.yardstick.trace import TraceReading

REPO = spec.REPO
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_piece_loads_by_name():
    bench = spec.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.config["name"] == w["config"]
        assert (REPO / configs[w["config"]]["file"]).exists()
        assert cell.chips == w["chips"]
        assert cell.runner().run and cell.reference().named_shapes
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        chosen = spec.metrics_of(bench, w["name"])
        names = {m["name"] for m in chosen["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert chosen["per_layer"]
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("name,stem", [
    ("device_idle_pct.train", "device_idle_pct"),
    ("device_idle_pct.eval", "device_idle_pct"),
    ("host_step_ms.train", "host_step_ms.train"),
    ("train_mfu_pct", "train_mfu_pct")])
def test_a_kind_without_a_reader_of_its_own_reads_the_metrics(name, stem):
    assert spec.metric_reader(name).__file__.endswith(f"/{stem}.py")


def test_configuration_files_are_frozen_copies():
    shipped = json.loads((REPO / "configs/config.json").read_text())
    liver = spec.load_json(spec.ROOT / "configs/vnet3d_liver.json")
    net = dict(liver["settings"]["TrainingSetting"]["Networks"])
    assert net.pop("Remat") is True
    assert net == shipped["TrainingSetting"]["Networks"]
    att = spec.load_json(spec.ROOT / "configs/attention3d_mm.json")
    assert att["settings"]["TrainingSetting"]["BatchSize"] == 16


def test_result_line_keys_and_checks_last():
    cell = spec.load_cell("vnet3d_liver.eval_512xD_gauss")
    numbers = {k: v / 2 for k, v in cell.limits.items()}
    out = Outcome(metrics={"eval_mvox_per_s": 40.0, "eval_volume_p95_s": 3.0,
                           "setup_s": 30.0, "peak_mem_gib": 9.0},
                  numbers=numbers, attempted=20)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        get_device_name=lambda i: "NVIDIA H100 80GB HBM3"))
    line, checks = harness.result_line(
        cell, out, spec.benchmark(), False,
        harness.device_line(fake, 1, 123))
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"eval_mvox_per_s", "eval_volume_p95_s",
                                    "setup_s", "peak_mem_gib"}
    assert line["metrics"]["setup_s"] == {"value": 30.0, "unit": "s"}
    assert line["device"]["memory_peak_bytes"] == 123
    out.reading = TraceReading(window_s=2.0, device=[("x", 0.0, 5e5)])
    traced, _ = harness.result_line(cell, out, spec.benchmark(), True,
                                    harness.device_line(fake, 1, 1,
                                                        out.reading))
    assert list(traced) == KEYS + ["breakdown", "checks"]
    assert traced["device"]["busy_s"] == 0.5
    assert traced["metrics"]["device_idle_pct.eval"]["value"] == 75.0
    out.numbers = {k: 2 * v for k, v in cell.limits.items()}
    assert harness.result_line(cell, out, spec.benchmark(), False,
                               {})[0]["correct"] is False


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("folder", ["reference", "yardstick"])
def test_reference_and_yardstick_import_nothing_of_the_port(folder):
    for path in (spec.ROOT / folder).glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"vnet_tpu_torch", "vnet_tpu", "jax", "jaxlib",
                           "flax"}, path


def test_no_jax_in_a_runs_process():
    """A fresh interpreter runs each runner at a tiny size, then lists the
    forbidden modules it loaded (top-level names compared whole)."""
    code = (
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.tests.conftest import tiny, TRAIN, EVAL, ATTENTION\n"
        "from portbench import run\n"
        "for c in (tiny(TRAIN, [16, 16, 8], 2),"
        " tiny(ATTENTION, [16, 16, 16], 2),"
        " tiny(EVAL, [16, 16, 8], 2, xy=[24, 24], depths=[8, 16])):\n"
        "    c.runner().run(c, 3, 0.2, False, time.perf_counter(), 'cpu')\n"
        "import vnet_tpu_torch\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vnet_tpu_torch_extra",
                        types.ModuleType("vnet_tpu_torch_extra"))
    assert "vnet_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax.numpy" in harness.forbidden_modules()


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "vnet3d_liver.eval_512xD_gauss", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _cli(REPO, env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _cli(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "attention3d_mm.train_64_b16", "--seed", "2147483649", "--seconds",
         "3", "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["device"]["busy_s"] > 0
