"""The span attribution (``yardstick/spans.py``) on hand-written Chrome
traces: innermost span across two threads, unmatched device time, the
seven readings, and the trace reduction's existing readings unmoved by the
program's ``vnet.`` spans."""

from __future__ import annotations

import json

import pytest

from portbench import spec
from portbench.yardstick import spans, trace

BASE = 1.7e12  # Kineto's microseconds since an epoch


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": BASE + ts, "dur": dur,
          "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1.0, tid, corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, tid=7, corr=corr)


def train_events(lost_us=0.5):
    """One step: the step's thread opens the step, forward and backward;
    autograd's thread (tid 2) a recompute inside the backward. Device us
    launched: step 8 + 5, forward 20 + 10, recompute 12, backward 30,
    outside 1; ``lost_us`` with no launch."""
    return [
        _x("user_annotation", "portbench.train_step", 0, 200),
        _x("user_annotation", "vnet.train.step", 1, 198),
        _x("user_annotation", "vnet.train.forward", 10, 50),
        _x("user_annotation", "vnet.train.backward", 70, 120),
        _x("user_annotation", "vnet.remat.recompute", 80, 30, tid=2),
        _x("cpu_op", "aten::copy_", 4, 3),
        _x("cpu_op", "aten::convolution", 11, 25),
        _x("cpu_op", "Optimizer.step#Adam.step", 191, 6),
        _launch(5, 1), _kernel("Memcpy HtoD (Pageable -> Device)", 6, 8, 1,
                               "gpu_memcpy"),
        _launch(12, 2), _kernel("void fprop_conv", 15, 20, 2),
        _launch(30, 3), _kernel("elementwise_kernel", 35, 10, 3),
        _launch(85, 4, tid=2), _kernel("dropout_kernel", 86, 12, 4),
        _launch(120, 5, tid=2), _kernel("sm90_dgrad", 121, 30, 5),
        _launch(192, 6), _kernel("multi_tensor_apply_kernel", 193, 5, 6),
        _launch(205, 7), _kernel("Memcpy DtoH (Device -> Pageable)", 206, 1,
                                 7, "gpu_memcpy"),
        _kernel("reduce_kernel", 160, lost_us, 99),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "vnet.train.step",
         "ts": BASE + 6, "dur": 192, "args": {"correlation": 1}},
    ]


def eval_events():
    """A volume of two batches: the upload, a forward and a blend a batch
    inside the volume span, the sums' copy out of it."""
    ev = [
        _x("user_annotation", "portbench.volume", 0, 130),
        _x("user_annotation", "vnet.engine.volume", 1, 98),
        _launch(2, 1), _kernel("Memcpy HtoD", 3, 5, 1, "gpu_memcpy"),
        _launch(105, 8), _kernel("Memcpy DtoH", 106, 20, 8, "gpu_memcpy"),
    ]
    for b in range(2):
        t = 10 + 40 * b
        ev += [_x("user_annotation", "vnet.engine.forward", t, 20),
               _launch(t + 2, 2 + b), _kernel("fprop", t + 3, 10 + 2 * b,
                                              2 + b),
               _launch(t + 25, 5 + b),
               _kernel("blend_accumulate_kernel", t + 30, 3, 5 + b)]
    return ev


def test_innermost_span_across_threads():
    r = spans.attribute(train_events())
    assert r.launched_ms == pytest.approx({
        "vnet.train.step": 0.013, "vnet.train.forward": 0.030,
        "vnet.remat.recompute": 0.012, "vnet.train.backward": 0.030,
        "": 0.001})
    assert r.unmatched_ms == pytest.approx(0.0005)
    assert sum(d for _, _, d in r.device) == pytest.approx(86.5)
    assert spans._trusted(r)
    # starts from the first device event (the upload, 6 us in)
    assert ("vnet.remat.recompute", 74.0, 30.0) in r.program
    assert [n for n, _, _ in r.program] == [
        "vnet.train.step", "vnet.train.forward", "vnet.train.backward",
        "vnet.remat.recompute"]


TRAIN_EXPECTED = {
    "forward_ms.train": 0.030, "backward_ms.train": 0.030,
    "recompute_ms.train": 0.012, "step_own_ms.train": 0.013,
    # the step span 198 us, of which the device ran 85.5
    "step_idle_ms.train": 0.1125}
EVAL_EXPECTED = {"engine_forward_ms.eval": 0.011,
                 "engine_own_ms.eval": 0.0055}


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_each_reading(name):
    if name in TRAIN_EXPECTED:
        r, want = spans.attribute(train_events()), TRAIN_EXPECTED[name]
        r.steps = 1
    else:
        r, want = spans.attribute(eval_events()), EVAL_EXPECTED[name]
        r.steps = 2
    assert spans.READINGS[name](r) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_readings_refuse_what_they_cannot_trust(name):
    train = name.endswith(".train")
    # more than 1% of the device time unmatched
    r = spans.attribute(train_events(lost_us=1.0) if train
                        else eval_events() + [_kernel("x", 200, 1.0, 77)])
    r.steps = 1 if train else 2
    assert not spans._trusted(r)
    assert spans.READINGS[name](r) is None
    # the spans' count against the window's steps
    r = spans.attribute(train_events() if train else eval_events())
    r.steps = 2 if train else 3
    assert spans.READINGS[name](r) is None
    # no spans: the parent's program
    r = spans.attribute([e for e in (train_events() if train
                                     else eval_events())
                         if not e["name"].startswith("vnet.")])
    r.steps = 1 if train else 2
    assert spans.READINGS[name](r) is None


def test_recompute_needs_a_whole_multiple_of_steps():
    events = train_events() + [
        _x("user_annotation", "vnet.remat.recompute", 150, 10, tid=2)]
    r = spans.attribute(events)
    r.steps = 1
    assert spans.recompute_ms_train(r) == pytest.approx(0.012)
    r = spans.attribute(events + [
        _x("user_annotation", "vnet.train.step", 300, 10),
        _x("user_annotation", "vnet.remat.recompute", 302, 2, tid=2)])
    r.steps = 2
    assert spans.recompute_ms_train(r) is None  # 3 recomputes, 2 steps


EXISTING = ("train_mfu_pct", "eval_mfu_pct", "device_idle_pct.train",
            "device_idle_pct.eval", "net_elementwise_ms.train",
            "net_elementwise_ms.eval", "net_conv_ms.train",
            "host_step_ms.train", "copies_pct.eval",
            "dropout_roofline.train", "blend_roofline.eval")


@pytest.mark.parametrize("events", [train_events, eval_events])
def test_existing_readings_unmoved_by_the_program_spans(tmp_path, events):
    """The trace reduction's fields and the eleven readers read the same
    with and without the ``vnet.`` spans; only the idle gaps' names
    move."""
    read = {}
    for label, evs in (("with", events()), ("without", [
            e for e in events() if not e["name"].startswith("vnet.")])):
        path = tmp_path / f"{label}.json"
        path.write_text(json.dumps({"traceEvents": evs}))
        r = trace.read_chrome_trace(str(path), 2e-4)
        r.steps = 2
        r.work = {"flops": 1e6, "dropout_bytes": 4e3, "dropout_launches": 1,
                  "blend_bytes": 8e3, "blend_launches": 2}
        read[label] = r
    got, base = read["with"], read["without"]
    for f in ("window_s", "device", "spans", "host_ms", "steps", "work"):
        assert getattr(got, f) == getattr(base, f), f
    for name in EXISTING:
        reader = spec.metric_reader(name)
        assert reader.read(got) == reader.read(base), name
    assert any(n.startswith("vnet.") for n, _ in got.gaps)
    assert not any(n.startswith("vnet.") for n, _ in base.gaps)
    assert sum(s for _, s in got.gaps) == pytest.approx(
        sum(s for _, s in base.gaps))
