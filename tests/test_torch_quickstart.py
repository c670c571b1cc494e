"""The port's quickstart (``python -m vnet_tpu_torch.quickstart``) against
the repo's ``scripts/quickstart.py``: the same dataset files from the same
seed, the same config tree and ``pipeline.yaml`` for every mode that
``tests/test_quickstart_configs.py`` covers (loaded as it loads them), each
accepted by the port's ``load_config`` and transform registry; then tiny
CPU runs, 3D and ``--rank2``, end to end.
"""

import importlib.util
import itertools
import json
import os
import sys

import numpy as np
import pytest
import yaml

from vnet_tpu_torch import quickstart as tqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [p for p in itertools.product([False, True], repeat=4)
         if not (p[0] and p[2])]  # --rank2 --multimodal isn't a shipped mode


def _load_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart", os.path.join(REPO, "scripts", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["quickstart"] = mod
    spec.loader.exec_module(mod)
    return mod


def _patch(rank2, small):
    if rank2:
        return (48, 48) if small else (96, 96)
    return (32, 32, 32) if small else (64, 64, 64)


def _replace_root(tree, old, new):
    """The tree with every string's ``old`` prefix replaced by ``new``."""
    if isinstance(tree, dict):
        return {k: _replace_root(v, old, new) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replace_root(v, old, new) for v in tree]
    if isinstance(tree, str) and tree.startswith(old):
        return new + tree[len(old):]
    return tree


@pytest.mark.parametrize("rank2,augment,multimodal,small", MODES)
def test_write_config_equals_jax(tmp_path, rank2, augment, multimodal,
                                 small):
    from vnet_tpu_torch.config import load_config
    from vnet_tpu_torch.data.registry import build_transform_list

    jqs = _load_quickstart()
    patch = _patch(rank2, small)
    kw = dict(steps=10, small=small, augment=augment, multimodal=multimodal,
              drop_ratio=0.3, min_pixel=32, lr=2e-3, seed=1337)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpath = jqs.write_config(str(tmp_path / "jax"), patch, **kw)
    tpath = tqs.write_config(str(tmp_path / "port"), patch, **kw)
    trees = []
    for path in (jpath, tpath):
        with open(path) as f:
            trees.append(json.load(f))
    assert _replace_root(trees[0], str(tmp_path / "jax"),
                         str(tmp_path / "port")) == trees[1]
    pipelines = []
    for root in ("jax", "port"):
        with open(tmp_path / root / "pipeline.yaml") as f:
            pipelines.append(yaml.safe_load(f))
    assert pipelines[0] == pipelines[1]

    cfg = load_config(tpath)
    assert cfg.train.max_iterations == 10
    assert len(cfg.train.image_filenames) == (2 if multimodal else 1)
    built = 0
    for phase, sections in pipelines[1]["preprocess"].items():
        for dim_key, entries in sections.items():
            tfms = build_transform_list(2 if dim_key == "2D" else 3, entries)
            built += len(tfms)
            if entries:
                assert len(tfms) == len(entries), (phase, dim_key)
    assert built > 0


@pytest.mark.parametrize("multimodal,contrast", [(False, 0.6), (True, 0.6),
                                                 (False, 2.0)])
def test_build_dataset_equals_jax(tmp_path, multimodal, contrast):
    jqs = _load_quickstart()
    for name, mod in (("jax", jqs), ("port", tqs)):
        mod.build_dataset(str(tmp_path / name), (24, 24, 16), n_train=2,
                          n_eval=1, multimodal=multimodal, contrast=contrast,
                          seed=1337)
    for d, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            mine = os.path.join(str(tmp_path / "port"),
                                os.path.relpath(os.path.join(d, f),
                                                tmp_path / "jax"))
            with open(os.path.join(d, f), "rb") as a, open(mine, "rb") as b:
                assert a.read() == b.read(), mine


def _run(capsys, argv):
    result = tqs.main(argv)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    return result["quickstart"]


@pytest.mark.parametrize("rank2", [False, True])
def test_tiny_quickstart_runs_on_cpu(tmp_path, capsys, monkeypatch, rank2):
    from vnet_tpu_torch import profiler

    traces = []

    class Recorded(profiler.TraceCapture):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            traces.append(self)

    monkeypatch.setattr(profiler, "TraceCapture", Recorded)
    wd = str(tmp_path / "wd")
    argv = ["--workdir", wd, "--steps", "2", "--n-train", "2",
            "--device", "cpu"] + (["--rank2"] if rank2 else [])
    out = _run(capsys, argv + ["--small", "--idle_window", "0", "1"])
    assert out["steps"] == 2 and out["device"] == "cpu"
    # the trainer drove the window, one step() a step; nothing read on the CPU
    assert len(traces) == 1 and len(traces[0]._stamps) == 3
    assert out["idle"] is None
    assert out["mode"] == ("2d" if rank2 else "3d")
    modes = ["batch_stats", "ema"] if rank2 else ["network"]
    assert sorted(out["dice"]) == modes
    for mode in modes:
        assert sorted(out["dice"][mode]) == ["case_0", "case_1"]
        for scores in out["dice"][mode].values():
            assert len(scores) == 3
            assert all(0.0 <= d <= 1.0 for d in scores)
    assert out["median_step_ms"] is None or out["median_step_ms"] > 0
    assert set(out["wall"]) == {"data_s", "train_s"} | {
        f"evaluate_{m}_s" for m in modes}
    case = os.path.join(wd, "evaluate", "case_0")
    if rank2:
        # one prediction set per mode, where the JAX script overwrites
        from vnet_tpu_torch.io import read_image
        files = [os.path.join(case, f) for f in tqs.RANK2_MODES.values()]
        assert all(os.path.exists(f) for f in files)
        preds = [np.asarray(read_image(f).data) for f in files]
        assert preds[0].shape == preds[1].shape == (48, 48, 32)
        assert not os.path.exists(os.path.join(case, "pred.nii.gz"))
    else:
        assert os.path.exists(os.path.join(case, "pred.nii.gz"))

    # the workdir's data were made with other knobs: refuse to run
    with pytest.raises(SystemExit, match="holds a dataset generated"):
        tqs.main(argv + ["--small", "--seed", "7"])


def test_quickstart_cpu_implies_small_and_cuda_is_the_default():
    args = tqs.get_parser().parse_args([])
    assert args.device == "cuda" and args.small is None


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks the refusal where torch sees no card")
def test_quickstart_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqs.main(["--workdir", str(tmp_path / "wd"), "--steps", "1"])
    assert not os.path.exists(tmp_path / "wd" / "training")


def test_device_busy_merges_overlapping_device_intervals():
    """The idle share's arithmetic (``profiler.device_busy``): the span from
    the first host event to the last device event, busy the union of the
    device intervals."""
    import types

    import torch

    from vnet_tpu_torch.profiler import device_busy

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start, end, kind):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=start, end=end),
            device_type=kind)

    class Trace:
        def __init__(self, events):
            self._events = events

        def events(self):
            return self._events

    trace = Trace([ev(0, 5, cpu), ev(10, 20, cuda), ev(15, 30, cuda),
                   ev(30, 35, cuda), ev(60, 100, cuda), ev(70, 80, cpu)])
    assert device_busy(trace) == (0.1, 0.065)  # us in, ms out
    span, busy = device_busy(Trace([ev(0, 5, cpu)]))
    assert np.isnan(span) and busy == 0.0


@pytest.mark.parametrize("first,count", [(3, 2), (1, 3), (0, 2)])
def test_trace_window_reads_the_steps_it_profiled(monkeypatch, first, count):
    """``TraceCapture(steps=(first, count))`` through torch's own profiler
    schedule (host activity standing in for the card's, which this build
    lacks): the window closes after step ``first + count``, its span is
    steps ``first + 1`` to ``first + count`` on the host clock, and the
    unprofiled step is the median of the others (steps 1-2, the warm-up
    step ``first`` and the step after the window left out)."""
    import time

    import torch

    from vnet_tpu_torch import profiler

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda activities, **kw:
                        real(activities=[torch.profiler.ProfilerActivity.CPU],
                             **kw))
    monkeypatch.setattr(profiler, "device_busy",
                        lambda prof: (float("nan"), 5.0))
    trace = profiler.TraceCapture(None, "cuda", steps=(first, count))
    closed = []
    done = trace._window_done
    monkeypatch.setattr(trace, "_window_done", lambda prof: (
        closed.append(len(trace._stamps) - 1), done(prof)))
    trace.start()
    for k in range(1, 11):
        time.sleep(0.03 if first < k <= first + count
                   else 0.05 if k <= 2 or k == first + count + 1 else 0.01)
        trace.step()
    trace.stop()
    assert closed == [first + count]
    r = trace.reading
    assert (r["steps"], r["first_step"], r["busy_ms"]) == (count, first + 1,
                                                           5.0)
    assert 30.0 * count <= r["span_ms"] < 30.0 * count + 30.0
    assert r["step_ms"] == r["span_ms"] / count
    assert 10.0 <= r["unprofiled_step_ms"] < 25.0  # the 10 ms steps
    assert r["idle"] == pytest.approx(1 - 5.0 / r["span_ms"])
    assert r["idle_unprofiled"] == pytest.approx(
        1 - 5.0 / count / r["unprofiled_step_ms"])
    assert trace.path is None  # no log_dir, no file

    # a loop that ends inside the window leaves no reading
    short = profiler.TraceCapture(None, "cuda", steps=(3, 2))
    short.start()
    for _ in range(4):
        short.step()
    short.stop()
    assert short.reading is None

    # on the CPU nothing is profiled: the steps are stamped, no reading
    cpu = profiler.TraceCapture(None, "cpu", steps=(1, 2))
    cpu.start()
    for _ in range(4):
        cpu.step()
    cpu.stop()
    assert len(cpu._stamps) == 5 and cpu.reading is None
