"""The PyTorch port imports no JAX and nothing of the JAX package.

``tests/conftest.py`` imports jax into this process, so the import check
runs in a fresh interpreter; the source checks read every port file and
``chip_smoke.py``. The ``cuda``-marked tests live in JAX-free modules,
``tests/test_torch_cuda_*.py``, so the card's machine, which has no JAX,
runs them: they are held to the same checks, and they import nothing but
torch, numpy, pytest and the port.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "vnet_tpu_torch").rglob("*.py")) + ["chip_smoke"]
CUDA_TESTS = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "tests").glob("test_torch_cuda_*.py"))
RANK_MODULES = sorted(str(p.relative_to(ROOT)) for p in
                      (ROOT / "tests").glob("torch_*_ranks.py"))
PORT_SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                      (ROOT / "vnet_tpu_torch").rglob("*.py")) + [
                          "chip_smoke.py"] + CUDA_TESTS + RANK_MODULES


def test_port_import_leaves_jax_out():
    """The port, the ``cuda``-marked modules and the functions that
    ``tests/test_torch_parallel.py`` and ``tests/test_torch_spatial.py``
    spawn as ranks import no JAX."""
    modules = PORT_MODULES + [os.path.basename(p)[:-3]
                              for p in CUDA_TESTS + RANK_MODULES]
    code = ("import importlib, sys\n"
            "sys.path.insert(0, 'tests')\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'vnet_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'flax', 'vnet_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("relpath", PORT_SOURCES)
def test_port_source_has_no_jax_import(relpath):
    text = (ROOT / relpath).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import flax|from flax)",
                         text, re.MULTILINE), relpath


def test_chip_smoke_names_no_jax_package_module():
    """The smoke run reaches everything through ``vnet_tpu_torch``."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+vnet_tpu\b", text,
                         re.MULTILINE), "chip_smoke.py imports vnet_tpu"


def test_port_modules_cover_the_package():
    for module in ("data.loader", "data.dataset2d", "data.transforms2d",
                   "io", "ops.fused", "ops.batchnorm",
                   "models.attention", "data.device_aug", "data.distance",
                   "train.events", "train.images", "profiler",
                   "parallel", "parallel.mesh", "parallel.halo",
                   "parallel.spatial", "parallel.tensor",
                   "tools.dryrun_multichip", "quickstart", "flags.train",
                   "flags.evaluate", "experiments.attn_quality",
                   "experiments.lits_rehearsal",
                   "experiments.attention_step",
                   "utils.synthdata", "utils.batch_evaluate", "utils.bbox",
                   "utils.prepare_data", "utils.prepare_data.prepare",
                   "utils.prepare_data.__main__", "export", "native",
                   "tools.benchmark_eval", "tools.benchmark_loader",
                   "tools.analyze_trace", "experiments.eval2d",
                   "experiments.eval_only", "experiments.compare_preds",
                   "experiments.patch_diagnose", "experiments.diag2d",
                   "experiments.diag2d.oracle2d_r5",
                   "experiments.diag2d.oracle2d_sweep",
                   "experiments.diag2d.probe2d_r5",
                   "experiments.diag2d.probe2d_r5b",
                   "experiments.diag2d.probe2d_r5c", "experiments.ab_train",
                   "experiments.capture_trace",
                   "tools.select_bench_tuning", "ops.bn_act",
                   "tools.bn_act_bench"):
        assert f"vnet_tpu_torch.{module}" in PORT_MODULES, module
    assert {os.path.basename(p) for p in CUDA_TESTS} == {
        f"test_torch_cuda_{k}.py" for k in ("blend", "fused", "dropout",
                                            "batchnorm", "dw_conv",
                                            "bn_act")}


@pytest.mark.parametrize("relpath", CUDA_TESTS)
def test_cuda_tests_import_only_torch_numpy_pytest_and_the_port(relpath):
    text = (ROOT / relpath).read_text()
    roots = set(re.findall(r"^\s*(?:from|import)\s+(\w+)", text,
                           re.MULTILINE))
    assert roots <= {"numpy", "pytest", "torch", "vnet_tpu_torch"}, roots


@pytest.mark.parametrize("relpath", PORT_SOURCES)
def test_port_source_imports_no_jax_package_module(relpath):
    """Not even a module of ``vnet_tpu`` that imports no JAX: the port
    keeps its own copies (``config``, ``io``, ``data``)."""
    text = (ROOT / relpath).read_text()
    assert not re.search(r"^\s*(from|import)\s+vnet_tpu(\.|\s|$)", text,
                         re.MULTILINE), relpath
