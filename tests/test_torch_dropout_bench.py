"""``tools/dropout_bench.py`` on the CPU: the dropout shapes it lists come
from the module trees of the three main-path steps (packed networks, as the
trainer builds them), and a real training
step of each launches the dropout wrapper twice per listed layer, at those
shapes. The timing needs a card; the enumeration, the launch count, the
layout-copy count and the variant sources do not."""

import importlib
import math
from collections import Counter

import pytest
import torch

from vnet_tpu_torch.tools import dropout_bench, profile_step

# the module, not the function that vnet_tpu_torch.ops re-exports
dropout_ops = importlib.import_module("vnet_tpu_torch.ops.dropout")

# the packed networks the trainer builds (PackedTargetLanes 128): the same
# elements as the direct networks' dropout inputs, in packed shapes
FLAGSHIP = [((96, 128, 32, 32, 32), 2), ((96, 128, 16, 16, 32), 4),
            ((96, 128, 8, 16, 16), 6), ((96, 128, 8, 8, 8), 6),
            ((96, 256, 4, 4, 4), 3)]
ATTENTION = [((8, 128, 32, 32, 32), 2), ((8, 128, 16, 16, 32), 4),
             ((8, 128, 8, 16, 16), 6), ((8, 128, 8, 8, 8), 6),
             ((8, 256, 4, 4, 4), 3), ((8, 64, 64, 64, 64), 12)]
TWO_D = [((32, 64, 128, 128), 2), ((32, 128, 64, 64), 4),
         ((32, 128, 32, 64), 6), ((32, 128, 32, 32), 6),
         ((32, 256, 16, 16), 3)]


@pytest.mark.parametrize("step,expect,layers", [
    ("flagship", FLAGSHIP, 21), ("attention", ATTENTION, 33),
    ("2d", TWO_D, 21)])
def test_shapes_are_the_module_trees_at_full_size(step, expect, layers):
    shapes = dropout_bench.dropout_shapes(step)
    assert sorted(shapes) == sorted(expect)
    assert sum(n for _, n in shapes) == layers


# (step, profile_step builder, flavour, tiny patch)
STEP_BUILDERS = [
    ("flagship", profile_step.flagship_step, "pallas", (16, 16, 16)),
    ("attention", profile_step.attention_step, "xla", (16, 16, 16)),
    ("2d", profile_step.config2d_step, "xla", (32, 32))]


@pytest.mark.parametrize("step,build,impl,patch", STEP_BUILDERS,
                         ids=[s[0] for s in STEP_BUILDERS])
def test_a_training_step_launches_twice_per_listed_layer(
        step, build, impl, patch, monkeypatch):
    """One real training step on the CPU at a tiny patch, batch 2: the
    dropout wrapper runs once forward and once backward for each layer the
    enumeration lists at that patch, on inputs of the listed shapes."""
    calls = []
    real = dropout_ops.dropout_apply

    def counted(x, *args):
        calls.append(tuple(x.shape))
        return real(x, *args)

    monkeypatch.setattr(dropout_ops, "dropout_apply", counted)
    state, fn, images, labels = build(impl, 2, device="cpu", patch=patch)
    out = fn(state, images, labels, dropout_seed=3)
    assert math.isfinite(float(out.loss))
    listed = dropout_bench.dropout_shapes(step, patch=patch, batch=2)
    assert Counter(calls) == Counter({s: 2 * n for s, n in listed})
    layers = {"flagship": 21, "attention": 33, "2d": 21}[step]
    assert len(calls) == 2 * layers


@pytest.mark.parametrize("fmt", ["channels_last", "contiguous"])
def test_layout_copies_counts_copies_inside_dropout_only(fmt):
    """A gradient that is not channels-last is copied into the kernel's
    storage order inside the backward pass; one that is, is not. The
    forward's channels-last input is never copied."""
    x = torch.randn(2, 4, 6, 6, 6).contiguous(
        memory_format=torch.channels_last_3d).requires_grad_()
    g = torch.ones(2, 4, 6, 6, 6)
    if fmt == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last_3d)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        y = dropout_ops.dropout(x, 1, 2, 0.3, "xla")
        y.backward(g)
    copies = dropout_bench.layout_copies(prof.events())
    assert copies == {"forward": 0,
                      "backward": int(fmt == "contiguous")}


def test_bound_and_floor():
    """The byte bound reads x once and writes the output once; the floor
    under which no span can be right reads x and writes back what the L2
    cannot hold."""
    shape = (96, 16, 64, 64, 64)
    nbytes = 96 * 16 * 64 ** 3 * 2
    assert dropout_bench.bound_ms(shape) == pytest.approx(
        2 * nbytes / 3.35e12 * 1e3)
    assert dropout_bench.floor_ms(shape) == pytest.approx(
        (2 * nbytes - 50e6) / 3.35e12 * 1e3)
    small = (8, 256, 4, 4, 4)  # fits in the L2: the read alone
    assert dropout_bench.floor_ms(small) == pytest.approx(
        8 * 256 * 64 * 2 / 3.35e12 * 1e3)


@pytest.mark.parametrize("shape", [s for s, _ in FLAGSHIP])
def test_slab_map_is_a_space_ranks_slab_of_the_global_mask(shape):
    """``--space 2`` times space rank 1's slab of each flagship shape under
    the row map ``slab_map`` gives it: on the CPU, the plain version at that
    map is that slab of the unsharded mask (channels-last storage, so the
    first spatial axis is the logical dim 2)."""
    small = (2, 4) + shape[2:]  # the map reads its dims the same at any B, C
    slab, (base, row_len, row_stride) = dropout_bench.slab_map(small, 2)
    assert slab == small[:2] + (small[2] // 2,) + small[3:]
    assert (row_len, row_stride) == (math.prod(slab[1:]),
                                     math.prod(small[1:]))
    assert base == row_len
    params = dropout_ops.dropout_params(0.5, "pallas")
    x = torch.ones(small).contiguous(memory_format=torch.channels_last_3d)
    whole = dropout_ops.dropout_plain(x, 7, 3, *params)
    part = dropout_ops.dropout_plain(
        x[:, :, slab[2]:].contiguous(memory_format=torch.channels_last_3d),
        7, 3, *params, base, row_len, row_stride)
    assert torch.equal(part, whole[:, :, slab[2]:])


def test_span_median_drops_spans_that_cannot_be_right():
    """Truncated spans under the floor are dropped, not averaged in, and
    the median is never taken again for its value: too few spans left, or
    more spans than calls, fail (``device_ms`` then retakes the trace)."""
    spans = [0.5] * 30 + [0.6] * 15 + [0.1] * 5
    assert dropout_bench.span_median(spans, 50, 0.4) == (0.5, 5)
    with pytest.raises(SystemExit, match="at least the"):
        dropout_bench.span_median([0.5] * 24 + [0.1] * 26, 50, 0.4)
    with pytest.raises(SystemExit, match="51 device events"):
        dropout_bench.span_median([0.5] * 51, 50, 0.4)


class _FakeTrace:
    """A stand-in for ``torch.profiler.profile`` whose timed traces hold
    the spans (ms) of ``traces`` in turn; untimed traces (2 calls) too."""

    def __init__(self, traces):
        self.traces = list(traces)
        self.taken = 0

    def __call__(self, activities):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        spans = self.traces[min(self.taken, len(self.traces) - 1)]
        self.taken += 1
        cuda = torch.autograd.DeviceType.CUDA
        return [type("E", (), dict(
            name="dropout_kernel", device_type=cuda,
            time_range=type("R", (), dict(start=0.0, end=t * 1e3))))()
            for t in spans]


@pytest.mark.parametrize("refused", [0, 1, 3])
def test_device_ms_retakes_a_refused_trace(monkeypatch, refused):
    """A trace that ``span_median`` refuses (records lost or cut short) is
    taken again, by the same rule, up to TRACE_TRIES traces; the reading
    comes from the first trace it accepts, and four refusals raise."""
    bad = [0.1] * 38  # the H100 machine under host load: 38 short spans
    good = [0.5] * 30 + [0.6] * 20
    fake = _FakeTrace([bad] * refused + [good])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    ms, names, dropped, retakes = dropout_bench.device_ms(
        calls.append, 50, 0.4)
    assert (ms, names, dropped, retakes) == (0.5, ["dropout_kernel"], 0,
                                             refused)
    assert len(calls) == 2 + 50 * (refused + 1)
    fake = _FakeTrace([bad] * dropout_bench.TRACE_TRIES + [good])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    with pytest.raises(SystemExit, match="at least the"):
        dropout_bench.device_ms(calls.append, 50, 0.4)


def test_check_events_fails_where_the_input_fills_the_l2():
    """At 64 MB and above the event ms per launch must be within 15% of
    the device ms; below it the event time holds the host's enqueue and is
    not checked."""
    big, small = (32, 16, 256, 256), (32, 64, 64, 64)  # 67 MB, 17 MB
    dropout_bench.check_events("xla", big, 0.0520, 0.0590)
    with pytest.raises(SystemExit, match="more than 15% apart"):
        dropout_bench.check_events("xla", big, 0.0420, 0.0590)
    with pytest.raises(SystemExit, match="more than 15% apart"):
        dropout_bench.check_events("xla", big, 0.0700, 0.0590)
    dropout_bench.check_events("xla", small, 0.0140, 0.0290)


def test_kernel_registers_reads_each_instantiation():
    """nvcc's ptxas log names each dropout_kernel<T, DIV> (and, with the
    row-walk flag, <T, DIV, ROWS>) with its registers; other kernels and
    the lines between are passed over."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dropout_kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_xxNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114dropout_kernelI13__nv_bfloat16Lb1EEEvPKT_PS2_xxNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Used 12 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dropout_kernelIfLb0EEEvPKT_PS1_xxNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 36 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dropout_kernelI6__halfLb1EEEvPKT_PS2_xxNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dropout_kernelI13__nv_bfloat16Lb1ELb1EEEvPKT_PS2_xxxxxxxNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 42 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dropout_kernelIfLb0ELb0EEEvPKT_PS1_xxxxxxxNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 44 registers, used 0 barriers
"""
    assert dropout_bench.kernel_registers(log) == [
        ("bf16 divide", 46), ("f32 multiply", 36), ("f16 divide", 40),
        ("bf16 divide rows", 42), ("f32 multiply", 44)]
    assert dropout_bench.kernel_registers("") == []


def test_event_check_reads_checked_shapes_of_the_steps():
    """``tools/event_check.py`` reads shapes that ``dropout_bench`` lists
    for a step and holds to its event check (at least CHECK_BYTES)."""
    from vnet_tpu_torch.tools import event_check

    listed = {s for step in dropout_bench.STEPS
              for s, _ in dropout_bench.dropout_shapes(step)}
    for shape in event_check.SHAPES:
        assert shape in listed
        assert math.prod(shape) * 2 >= dropout_bench.CHECK_BYTES
