"""The benchmark's data-parallel runner (``portbench/runners/train_dp.py``)
and the readers of ``window_attn_ms.train``, ``window_attn_roofline.train``
and ``collectives_ms.train`` on the CPU.

The runner runs ``vnet3d_liver.train_dp4_b32`` cut to two ``gloo`` ranks
of a tiny network (``portbench/tests/conftest.py::tiny``, float32): a run
is correct against the reference on the whole global batch, and neither a
reference on half of each global batch in the program's place
(``readings``' ``half_batch``) nor the program without the gradients' or
the batch moments' all-reduce (``PROGRAM_FAULTS``) is. The readers read synthetic traces: the
kernels by name, the roofline from the Swin cell's counts
(``reference/swin_unetr_btcv.py::attention_step``), nothing where the
forward launches are not the count's or the run's model FLOPs are not the
cell's network at its batch and patch.
"""

import time

import pytest
import torch

from portbench import spec
from portbench.reference import swin_unetr_btcv
from portbench.runners import train_dp
from portbench.tests.conftest import tiny
from portbench.yardstick import compare, flops
from portbench.yardstick.trace import TraceReading

DP4 = "vnet3d_liver.train_dp4_b32"
SWIN = "swin_unetr_btcv.train_96_b8_remat"
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs in several workers at once,
    and these 3D convolutions on every core of each worker thrash."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny_dp():
    return tiny(DP4, [16, 16, 8], 4, ranks=2, data_parallel=2)


@pytest.fixture(scope="module")
def dp_readings(tiny_dp):
    """``readings`` of the seed with the half batch and every fault of the
    program."""
    return train_dp.readings(tiny_dp, SEED, "cpu",
                             ("half_batch",) + train_dp.PROGRAM_FAULTS)


def test_train_dp_run_is_correct_and_half_batch_is_caught(tiny_dp,
                                                         dp_readings):
    out = train_dp.run(tiny_dp, SEED, 0.5, True, time.perf_counter(), "cpu")
    assert out.attempted >= train_dp.STOP_EVERY and out.window_s > 0
    assert out.attempted % train_dp.STOP_EVERY == 0
    assert set(out.metrics) == {"train_patches_per_s", "setup_s",
                                "peak_mem_gib"}
    assert out.reading.steps == out.attempted
    assert out.reading.work["flops"] > 0
    assert compare.verdict(out.numbers, tiny_dp.limits)[0], out.numbers
    assert out.numbers == dp_readings["program"]
    numbers = dp_readings["half_batch"]
    assert not compare.verdict(numbers, tiny_dp.limits)[0], numbers


@pytest.mark.parametrize("fault", train_dp.PROGRAM_FAULTS)
def test_train_dp_without_an_exchange_is_caught(tiny_dp, dp_readings, fault):
    """The program with the gradients' or the batch moments' all-reduce
    taken out fails the check that the program passes."""
    numbers = dp_readings[fault]
    assert not compare.verdict(numbers, tiny_dp.limits)[0], numbers


def _reading(names, steps, work=None):
    device = [(name, 10.0 * i, 1000.0) for i, name in enumerate(names)]
    return TraceReading(window_s=1.0, device=device, steps=steps,
                        work=dict(work or {}))


def _swin_flops(steps, batch):
    """``runners/train.py``'s ``work["flops"]`` of ``steps`` Swin cell steps
    at ``batch``."""
    s = spec.load_cell(SWIN).settings
    per_voxel = swin_unetr_btcv.flops_per_voxel(s["network"])
    return steps * flops.train_step(per_voxel, batch, s["patch"])


def test_window_attention_readers():
    s = spec.load_cell(SWIN).settings
    work = swin_unetr_btcv.attention_step(s["batch"], s["network"])
    step = (["swin_wattn_fwd_kernel"] * work["fwd_launches"]
            + ["swin_wattn_bwd_kernel", "swin_wattn_dbias_partial_kernel",
               "swin_wattn_dbias_sum_kernel"] * 8 + ["elementwise_kernel"])
    roofline = spec.metric_reader("window_attn_roofline.train")
    r = _reading(step * 2, 2, {"flops": _swin_flops(2, s["batch"])})
    ms = spec.metric_reader("window_attn_ms.train").read(r)
    assert ms == pytest.approx(len(step) - 1)
    share = roofline.read(r)
    assert share == pytest.approx(100 * work["bound_s"] / (ms / 1e3))
    assert 0 < share < 100
    short = _reading(step[1:] * 2, 2, r.work)
    assert roofline.read(short) is None
    # another batch (its 16 forward launches a step as the cell's), or no
    # model FLOPs: the cell's counts do not hold
    other = _reading(step * 2, 2, {"flops": _swin_flops(2, s["batch"] // 2)})
    assert roofline.read(other) is None
    assert roofline.read(_reading(step * 2, 2)) is None
    none = _reading(["elementwise_kernel"], 1)
    for name in ("window_attn_ms.train", "window_attn_roofline.train"):
        assert spec.metric_reader(name).read(none) is None


def test_collectives_reader():
    r = _reading(["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] * 3
                 + ["elementwise_kernel"], 3)
    assert spec.metric_reader("collectives_ms.train").read(r) == \
        pytest.approx(1.0)
    assert spec.metric_reader("collectives_ms.train").read(
        _reading(["elementwise_kernel"], 1)) is None
