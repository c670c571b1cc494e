"""The PyTorch port imports no JAX.

``tests/conftest.py`` imports jax into this process, so the import check
runs in a fresh interpreter.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "vnet_tpu_torch", "vnet_tpu_torch.__main__", "vnet_tpu_torch.config",
    "vnet_tpu_torch.convert", "vnet_tpu_torch.models",
    "vnet_tpu_torch.models.layers", "vnet_tpu_torch.models.vnet",
    "vnet_tpu_torch.ops", "vnet_tpu_torch.ops.build",
    "vnet_tpu_torch.ops.blend", "vnet_tpu_torch.infer",
    "vnet_tpu_torch.infer.evaluator", "vnet_tpu_torch.infer.postprocess",
    "vnet_tpu_torch.infer.sliding_window", "vnet_tpu_torch.io",
    "vnet_tpu_torch.train",
    "vnet_tpu_torch.train.checkpoints", "chip_smoke",
]
PORT_SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                      (ROOT / "vnet_tpu_torch").rglob("*.py")) + [
                          "chip_smoke.py"]


def test_port_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'flax')))\n"
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
