"""The port's evaluation and loader tools against their JAX scripts, on the
CPU at tiny sizes, and the sliding window's tensor input.

* The engine takes a tensor (``SlidingWindowInference.device_volume``): a
  numpy volume and a CPU tensor give bitwise-equal ``(softmax_sum,
  weight)`` in 3D, slice-stacked and one-slice modes (the same arithmetic
  on the same values), and a float32 tensor on the engine's device is used
  in place. The card's case (a resident CUDA tensor, no copy) is in
  ``tests/test_torch_cuda_blend.py``.
* ``tools/benchmark_eval.py``: its engine (``build_engine``) at ``--size
  32 --patch 16 --stride 16 --batch 4`` in float32, on a tensor, against JAX's
  ``SlidingWindowInference`` on a ``jax.Array`` with the same weights
  (``convert.py``), within ``rtol`` 1e-4 of the largest sum (float32 sums
  in other orders on the two sides); ``main()`` prints the JAX script's
  lines and its JSON line on the CPU.
* ``experiments/eval2d.py``: stacked and per-slice labels equal at a tiny
  stack (eval-mode batch norm reads running averages, so a patch's output
  does not depend on its batch), as ``tests/test_evaluator_2d.py`` holds
  them for JAX; its log lines carry the JAX script's keys.
* ``tools/benchmark_loader.py``: ``make_cases`` writes the JAX script's
  files byte for byte; ``run`` returns the JAX script's keys at 2 cases of
  32^3, both backends.
* ``tools/analyze_trace.py``: a synthetic ``torch.profiler`` trace (two
  kernels overlapping on two streams, a memcpy, a host operator, a
  ``python_function`` and a flow event) gives the union of the device
  intervals as busy time; the same busy intervals in the XLA format of
  ``tests/test_profiler.py`` give JAX's ``analyze_trace`` the same time.

Small networks run with one intra-op thread a test, as in
``tests/test_torch_remat.py``.
"""

import gzip
import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.infer import SlidingWindowInference as JaxSlidingWindow
from vnet_tpu.models import VNet as JaxVNet
from vnet_tpu_torch.convert import state_dict_to_flax
from vnet_tpu_torch.experiments import eval2d
from vnet_tpu_torch.infer.sliding_window import SlidingWindowInference
from vnet_tpu_torch.tools import analyze_trace, benchmark_eval
from vnet_tpu_torch.tools import benchmark_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_script(name, relpath):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *relpath.split("/")))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- engine

ENGINE_MODES = {
    # mode: (volume shape, patch, stride, slice_stacked)
    "3d": ((14, 12, 9, 2), (8, 8, 6), (5, 4, 3), False),
    "slice_stacked": ((5, 14, 12, 2), (8, 8), (5, 4), True),
    "one_slice": ((14, 12, 2), (8, 8), (5, 4), False),
}


def _batch_mean_model(c_in, classes=3, seed=7):
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(c_in, classes)).astype(np.float32))
    return lambda p: torch.einsum("...c,ck->...k", p - p.mean(), w)


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_tensor_equals_numpy_bitwise(mode, rng):
    shape, patch, stride, stacked = ENGINE_MODES[mode]
    volume = rng.normal(size=shape).astype(np.float32)
    engine = SlidingWindowInference(
        _batch_mean_model(shape[-1]), patch, stride, 5, 3,
        gaussian_blend=True, slice_stacked=stacked, device="cpu")
    ref = engine(volume)
    for given in (torch.from_numpy(volume.copy()),
                  torch.from_numpy(volume.astype(np.float64))):
        got = engine(given)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert ref[0].shape == shape[:-1] + (3,) and ref[1].shape == shape[:-1]


def test_engine_uses_a_tensor_on_its_device_in_place():
    engine = SlidingWindowInference(lambda p: p, (4, 4, 4), (4, 4, 4), 2, 1,
                                    device="cpu")
    vol = torch.zeros((8, 8, 8, 1))
    assert engine.device_volume(vol) is vol
    copied = engine.device_volume(vol.double())
    assert copied.dtype == torch.float32 and copied.data_ptr() != \
        vol.data_ptr()
    arr = np.zeros((8, 8, 8, 1), np.float64)
    assert engine.device_volume(arr).dtype == torch.float32


# --------------------------------------------------------- benchmark_eval

BE = dict(size=32, patch=16, stride=16, batch=4, classes=3)


def _jax_bench_model():
    """The JAX script's network, in float32."""
    return JaxVNet(num_classes=BE["classes"], num_channels=16, num_levels=4,
                   num_convolutions=(1, 2, 3, 3), bottom_convolutions=3,
                   dropout_rate=0.0, activation="prelu", norm="batch",
                   dtype=jnp.float32, conv_impl="packed",
                   packed_target_lanes=128)


def test_benchmark_eval_engine_matches_jax():
    """With ``--gaussian``, the cosine window in both."""
    engine, net = benchmark_eval.build_engine(
        BE["patch"], BE["stride"], BE["batch"], BE["classes"], True,
        "pallas", device="cpu", dtype=torch.float32)
    variables = state_dict_to_flax(net.state_dict())
    model = _jax_bench_model()
    jengine = JaxSlidingWindow(
        lambda v, p: model.apply(v, p, train=False), (BE["patch"],) * 3,
        (BE["stride"],) * 3, BE["batch"], BE["classes"],
        gaussian_blend=True, blend_impl="xla")
    host = np.random.default_rng(0).normal(
        size=(BE["size"],) * 3 + (1,)).astype(np.float32)
    vol, _ = benchmark_eval.resident_volume(BE["size"], "cpu")
    np.testing.assert_array_equal(vol.numpy(), host)
    acc, w = engine(vol)
    jacc, jw = jengine(variables, jax.device_put(host))
    jacc, jw = np.asarray(jacc), np.asarray(jw)
    assert acc.shape == jacc.shape == (BE["size"],) * 3 + (BE["classes"],)
    np.testing.assert_allclose(acc.numpy(), jacc,
                               atol=RTOL * np.abs(jacc).max(), rtol=0)
    np.testing.assert_array_equal(w.numpy(), jw)


def test_benchmark_eval_main_prints_its_lines_on_the_cpu(capsys):
    out = benchmark_eval.main(
        ["--size", "32", "--patch", "16", "--stride", "16", "--batch", "4",
         "--reps", "1", "--blend-impl", "pallas", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("host->device transfer: ")
    assert lines[1].startswith("first call (compile + run): ")
    assert re.fullmatch(r"32\^3 sliding window stride=16 batch=4 "
                        r"gaussian=False blend=pallas: median \S+s over 1 "
                        r"reps", lines[2]), lines[2]
    rec = json.loads(lines[3])["benchmark_eval"]
    assert rec == out["benchmark_eval"]
    assert len(rec["times_s"]) == 1 and rec["median_s"] > 0
    assert rec["device"] == "cpu" and rec["blend_launches"] == 0
    assert rec["peak_gib"] is None and rec["card"] is None


def test_benchmark_eval_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card, so the default resolves")
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        benchmark_eval.main(["--size", "32", "--patch", "16"])


# ------------------------------------------------------------------ eval2d

def test_eval2d_stacked_equals_per_slice_labels():
    stacked, per_slice, _ = eval2d.build_engines(16, 8, 4, 3, "cpu",
                                                 dtype=torch.float32)
    stack = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 24, 20, 1)).astype(np.float32))
    a = eval2d.stacked_labels(stacked, stack)
    b = eval2d.per_slice_labels(per_slice, stack)
    assert a.shape == (3, 24, 20)
    assert torch.equal(a, b)


def test_eval2d_log_lines_carry_the_jax_keys(tmp_path):
    log = tmp_path / "eval2d.log"
    records = eval2d.main(["--log", str(log), "--size", "20", "--slices",
                           "2", "--patch", "16", "--stride", "8", "--batch",
                           "4", "--reps", "1", "--device", "cpu"])
    with open(os.path.join(REPO, "scripts", "experiments",
                           "eval2d.py")) as f:
        jax_keys = {k for rec in re.findall(r"record\(\{(.*?)\}\)", f.read(),
                                            re.DOTALL)
                    for k in re.findall(r'"(\w+)": ', rec)}
    assert len(jax_keys) == 10, jax_keys
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines == records
    assert [r["exp"] for r in lines] == ["eval2d_stacked", "eval2d_per_slice"]
    for r in lines:
        assert jax_keys <= set(r), jax_keys - set(r)
        assert r["slices"] == 2 and len(r["times_s"]) == 1
        assert r["slices_per_s"] == pytest.approx(2 / r["volume_s"])


# -------------------------------------------------------- benchmark_loader

def test_loader_make_cases_equal_the_jax_script(tmp_path):
    jax_loader = _load_script("benchmark_loader_jax",
                              "scripts/benchmark_loader.py")
    size = (20, 18, 12)
    port = benchmark_loader.make_cases(str(tmp_path / "port"), 2, size,
                                       np.random.default_rng(0))
    ref = jax_loader.make_cases(str(tmp_path / "jax"), 2, size,
                                np.random.default_rng(0))
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ref)
                           for d, _, fs in os.walk(ref) for f in fs)
    assert len(files) == 4
    for name in files:
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_loader_run_returns_the_jax_keys(tmp_path, backend):
    jax_loader = _load_script("benchmark_loader_jax",
                              "scripts/benchmark_loader.py")
    data_dir = benchmark_loader.make_cases(str(tmp_path), 2, (32, 32, 32),
                                           np.random.default_rng(0))
    args = benchmark_loader.parse_args(
        ["--cases", "2", "--size", "32", "32", "32", "--patch", "16",
         "--batch", "2", "--batches", "3", "--workers", "2", "--backend",
         backend])
    ref = jax_loader.run("lean", args, data_dir)
    for variant in benchmark_loader.VARIANTS:
        got = benchmark_loader.run(variant, args, data_dir)
        assert set(got) == set(ref)
        assert got["variant"] == variant and got["patches_per_s"] > 0
        assert {k: got[k] for k in ("workers", "backend", "batch", "patch",
                                    "cases", "case_size", "host_cpus")} == \
            {k: ref[k] for k in ("workers", "backend", "batch", "patch",
                                 "cases", "case_size", "host_cpus")}


# ------------------------------------------------------------ analyze_trace

def _torch_trace():
    """Kernels A [0, 600) on stream 7 and B [400, 900) on stream 13, a
    memcpy [900, 1000) us: busy 1.0 ms of 1.5 ms summed."""
    def x(name, cat, ts, dur, tid=7, pid=0):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur}
    return [
        x("aten::conv3d", "cpu_op", 0, 5000, tid=1, pid=100),
        x("model.py(12): forward", "python_function", 0, 6000, tid=1,
          pid=100),
        x("cudaLaunchKernel", "cuda_runtime", 10, 5, tid=1, pid=100),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 100,
         "tid": 1, "ts": 10},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
         "tid": 7, "ts": 0, "bp": "e"},
        x("blend_accumulate_kernel<float4, 4>", "kernel", 0, 600),
        x("sm90_xmma_gemm_bf16", "kernel", 400, 500, tid=13),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 900, 100),
    ]


@pytest.mark.parametrize("gz", [False, True])
def test_analyze_trace_unions_device_events(tmp_path, capsys, gz):
    events = _torch_trace()
    if gz:
        with gzip.open(tmp_path / "run.pt.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": events}, f)
    else:
        (tmp_path / "trace_1_2.json").write_text(
            json.dumps({"traceEvents": events}))
    s = analyze_trace.summarize(events)
    assert s["busy_ms"] == pytest.approx(1.0) and s["events"] == 3
    assert sum(s["groups"].values()) == pytest.approx(1.2)
    assert s["groups"]["blend kernel"] == pytest.approx(0.6)
    assert analyze_trace.main([str(tmp_path), "--group", "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "device busy time: 1.00 ms across 3 events" in out
    assert "by group" in out and "blend_accumulate_kernel" in out
    assert "aten::conv3d" not in out and "forward" not in out
    assert "Memcpy" not in out.split("top 2 ops:")[1]  # ranked third

    # the same busy intervals on one 'XLA Ops' track (B from where A
    # ends), as tests/test_profiler.py writes them, through JAX's script
    jax_trace = _load_script("analyze_trace_jax", "scripts/analyze_trace.py")
    xla = [{"ph": "M", "pid": 3, "tid": 3, "name": "thread_name",
            "args": {"name": "XLA Ops"}},
           {"ph": "X", "pid": 3, "tid": 3, "name": "fusion.1", "ts": 0,
            "dur": 600},
           {"ph": "X", "pid": 3, "tid": 3, "name": "convolution.2",
            "ts": 600, "dur": 300},
           {"ph": "X", "pid": 3, "tid": 3, "name": "copy.3", "ts": 900,
            "dur": 100}]
    d = tmp_path / "xla" / "plugins" / "profile" / "x"
    d.mkdir(parents=True)
    with gzip.open(d / "m.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": xla}, f)
    assert jax_trace.main([str(tmp_path / "xla")]) == 0
    assert "device busy time: 1.00 ms" in capsys.readouterr().out


@pytest.mark.parametrize("origin", [1e12, 1.7e15])
def test_analyze_trace_busy_at_epoch_timestamps(origin):
    """Kineto writes microseconds since an epoch. A thousand disjoint
    kernels there: the busy time is their summed durations, never more
    (``ts + dur`` at that magnitude rounded each end, and the union came
    out above the sum)."""
    rng = np.random.default_rng(0)
    events, t = [], origin
    for i in range(1000):
        dur = round(float(rng.uniform(1, 300)), 3)
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i % 7}",
                       "ts": round(t, 3), "dur": dur})
        t += dur + 2
    s = analyze_trace.summarize(events)
    summed = sum(s["groups"].values())
    assert s["busy_ms"] <= summed
    assert s["busy_ms"] == pytest.approx(summed, rel=1e-12, abs=0)


def test_analyze_trace_without_device_events_exits(tmp_path):
    (tmp_path / "trace_1_2.json").write_text(json.dumps(
        {"traceEvents": _torch_trace()[:5]}))
    with pytest.raises(SystemExit, match="no device events"):
        analyze_trace.main([str(tmp_path)])
    with pytest.raises(SystemExit, match="no trace_"):
        analyze_trace.main([str(tmp_path / "empty")])


def test_loader_refuses_fewer_cases_than_a_batch(tmp_path):
    """An epoch drops its last partial batch, so it would yield nothing."""
    data_dir = benchmark_loader.make_cases(str(tmp_path), 2, (16, 16, 16),
                                           np.random.default_rng(0))
    args = benchmark_loader.parse_args(["--cases", "2", "--batch", "4",
                                        "--patch", "8", "--workers", "1"])
    with pytest.raises(SystemExit, match="2 cases make no batch of 4"):
        benchmark_loader.run("lean", args, data_dir)
