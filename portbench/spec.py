"""Finding a cell's pieces by name: ``workloads/<cell>.json`` (the traffic
mix, its configuration, its runner kind and its check's limits),
``configs/<config>.json`` (a frozen copy of the shipped settings),
``reference/<config>.py``, ``runners/<kind>.py`` and
``metrics/<metric>.py`` (``<metric>.<kind>`` without a file of its own
reads ``metrics/<metric>.py``); and which of ``BENCHMARK.json``'s metrics a run
of the cell reports."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def settings(tree: dict) -> dict:
    """The plain settings the reference and the yardstick read, from the
    frozen JSON tree alone (nothing of the port's config parser)."""
    ts = tree["TrainingSetting"]
    net, lo, opt = ts["Networks"], ts["Loss"], ts["Optimizer"]
    es = tree.get("EvaluationSetting", {})
    return {
        "network": {
            "in_channels": len(ts["Data"]["ImageFilenames"]),
            "num_channel": int(net["NumChannel"]),
            "num_levels": int(net["NumLevels"]),
            "num_convolutions": [int(n) for n in net["NumConvolutions"]],
            "bottom_convolutions": int(net["BottomConvolutions"]),
            "num_classes": len(ts["SegmentationClasses"]),
            "dropout": float(net["Dropout"]),
            "attention": bool(net.get("Attention", False)),
            "attention_channels": int(net.get("AttentionChannels", 64)),
            "attention_blocks": int(net.get("AttentionBlocks", 3)),
            "packed_target_lanes": int(net.get("PackedTargetLanes", 128)),
        },
        "loss": {"name": lo["Name"],
                 "weights": [float(w) for w in lo.get("Weights", [])],
                 "alpha": float(lo.get("Alpha", 1.0)),
                 "attention_scale": float(lo.get("AttentionScale", 100.0))},
        "optimizer": {
            "name": opt["Name"],
            "initial_learning_rate": float(opt["InitialLearningRate"]),
            "decay_factor": float(opt["Decay"]["Factor"]),
            "decay_steps": float(opt["Decay"]["Steps"])},
        "batch": int(ts["BatchSize"]),
        "patch": [int(p) for p in ts["PatchShape"]],
        "precision": ts.get("Precision", "float32"),
        "eval": {"stride": [int(s) for s in es.get("Stride", [])],
                 "batch": int(es.get("BatchSize", 10)),
                 "gaussian": bool(es.get("GaussianBlend", False))},
    }


@dataclass
class Cell:
    """A cell's workload file, configuration file and their modules."""

    name: str
    workload: dict
    config: dict

    @property
    def tree(self) -> dict:
        """A copy of the frozen settings tree, as the program takes it."""
        return copy.deepcopy(self.config["settings"])

    @property
    def settings(self) -> dict:
        return settings(self.config["settings"])

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    def reference(self) -> ModuleType:
        return importlib.import_module(
            "portbench.reference." + _checked(self.config["name"]))

    def runner(self) -> ModuleType:
        return importlib.import_module(
            "portbench.runners." + _checked(self.workload["runner"]))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    workload = load_json(root / "workloads" / f"{_checked(name)}.json")
    config = load_json(root / "configs" / f"{_checked(workload['config'])}.json")
    return Cell(name, workload, config)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py``, or for ``<metric>.<kind>`` without a file of
    its own, the one reader ``metrics/<metric>.py`` of every kind."""
    path = root / "metrics" / f"{_checked(name)}.py"
    if not path.exists() and "." in name:
        path = root / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return load_module(path, "portbench.metrics." + path.stem.replace(".", "_"))


def _applies(entry: dict, cell: str, reported: Optional[set]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def metrics_of(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """``{"end_to_end": [...], "per_layer": [...]}``: the entries of
    ``BENCHMARK.json`` that a run of ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return {"end_to_end": e2e, "per_layer": per}


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")
