"""The yardstick against hand counts: FLOPs, bytes, the trace reduction,
the dropout counter hash and the 95th percentile."""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

from portbench.reference import attention3d_mm, vnet3d_liver
from portbench.yardstick import flops, nbytes, philox, trace


def test_flops_of_a_tiny_vnet_by_hand():
    net = dict(in_channels=1, num_channel=2, num_levels=1,
               num_convolutions=[2], bottom_convolutions=1, num_classes=3)
    # level 0 (V voxels): two 5^3 2->2 convs; down 2->4 on V/8; bottom one
    # 5^3 4->4 on V/8; up 4->2 on V/8; decoder one 5^3 4->2 and one 2->2;
    # output 1^3 2->3
    hand = (2 * (2 * 125 * 2 * 2) + (2 * 8 * 2 * 4) / 8
            + (2 * 125 * 4 * 4) / 8 + (2 * 8 * 4 * 2) / 8
            + 2 * 125 * 4 * 2 + 2 * 125 * 2 * 2 + 2 * 1 * 2 * 3)
    per_voxel = vnet3d_liver.flops_per_voxel(net)
    assert float(per_voxel) == hand
    assert flops.train_step(per_voxel, 2, (4, 4, 4)) == 3 * hand * 2 * 64
    assert flops.forward(per_voxel, 5, (4, 4, 4)) == hand * 5 * 64


def test_flops_of_the_shipped_networks():
    liver = dict(in_channels=1, num_channel=16, num_levels=4,
                 num_convolutions=[1, 2, 3, 3], bottom_convolutions=3,
                 num_classes=3)
    # encoder 200000, decoder 320000, bottom 12000, down and up 3840,
    # output 96 a voxel
    assert float(vnet3d_liver.flops_per_voxel(liver)) == 535936
    att = dict(liver, in_channels=2, num_classes=2, attention=True,
               attention_channels=64, attention_blocks=3)
    head = ((2 * 2 * 64 + 2 * 27 * 2 * 64 + 2 * 27 * 64 * 64)
            + 2 * (2 * 64 * 64 + 2 * 2 * 27 * 64 * 64) + 2 * 64 * 2)
    assert float(attention3d_mm.head_flops_per_voxel(att)) == head
    assert float(attention3d_mm.flops_per_voxel(att)) == (
        535936 - 96 + 2 * 16 * 2 + 2 * 125 * 2 * 16 + 2 * head)


def test_bytes_by_hand():
    assert nbytes.dropout_launch(1000) == 4000
    assert nbytes.dropout_launch(10, 4) == 80
    # two 2^3 boxes overlapping in a 1x2x2 slab: 8 + 8 - 4 cells
    assert nbytes.box_union_volume([(0, 0, 0), (1, 0, 0)], (2, 2, 2)) == 12
    assert nbytes.box_union_volume([(0, 0, 0), (0, 0, 0)], (2, 2, 2)) == 8
    assert nbytes.box_union_volume([(0, 0, 0), (5, 5, 5)], (2, 2, 2)) == 16
    # contributions 2 * 8 cells * 4 channels * 4 bytes, the union read
    # and written
    assert nbytes.blend_launch([(0, 0, 0), (1, 0, 0)], (2, 2, 2), 4) == (
        2 * 8 * 4 * 4 + 2 * 12 * 4 * 4)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_box_union_against_a_painted_grid(n):
    rng = np.random.default_rng(n)
    starts = rng.integers(0, 6, size=(n, 3))
    grid = np.zeros((10, 10, 10), bool)
    for x, y, z in starts:
        grid[x:x + 4, y:y + 3, z:z + 2] = True
    assert nbytes.box_union_volume(starts.tolist(), (4, 3, 2)) == grid.sum()


def test_busy_union_overlaps_and_gaps():
    assert trace.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.busy_union([(0, 10), (2, 3)]) == 10
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_outside_a_set_of_intervals():
    busy = [(0, 2), (5, 6), (8, 20)]
    assert trace.outside((1, 10), busy) == 9 - 1 - 1 - 2
    assert trace.outside((2, 5), busy) == 3
    assert trace.outside((-5, -1), busy) == 4
    assert trace.outside((9, 12), busy) == 0
    assert trace.outside((1, 3), []) == 2


def _trace_file(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_chrome_trace_at_epoch_scale(tmp_path):
    base = 1.7e12  # Kineto's microseconds since an epoch
    ev = [
        {"ph": "X", "cat": "kernel", "name": "dropout_kernel", "ts": base,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void fprop_conv", "ts": base + 5,
         "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts":
         base + 40, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": base + 14,
         "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.train_step",
         "ts": base - 5, "dur": 60.0},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": base,
         "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": base},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": base - 3, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": base + 20, "dur": 50.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuMemcpyHtoDAsync",
         "ts": base + 25, "dur": 5.0},
    ]
    r = trace.read_chrome_trace(_trace_file(tmp_path, ev), 1e-4)
    assert r.busy_s == pytest.approx(20e-6)
    assert r.group_ms("dropout kernel") == pytest.approx(0.01)
    assert r.group_ms("cuDNN convolution") == pytest.approx(0.01)
    assert r.name_ms("Memcpy") == (pytest.approx(0.005), 1)
    assert r.spans == {"portbench.train_step": [0.06]}
    # 60 us of span, 2 us in a launch, 35 us in a copy (its driver call
    # inside it counts once)
    assert r.host_ms == {"portbench.train_step": [pytest.approx(0.023)]}
    # the one gap (15 to 40 us) began inside aten::copy_
    assert r.gaps == [["aten::copy_", pytest.approx(25e-6)]]
    assert r.top_ops(2)[0][1] == pytest.approx(10e-6)


@pytest.mark.parametrize("name,group", [
    ("dropout_kernel<bf16>", "dropout kernel"),
    ("sm90_xmma_fprop_implicit_gemm", "cuDNN convolution"),
    ("nvjet_hsh_128x256", "matmul"), ("ncclDevKernel_AllReduce", "collectives"),
    ("vectorized_elementwise_kernel", "elementwise and other"),
    ("reduce_kernel<512>", "reductions"), ("Memcpy DtoH", "copies"),
    ("blend_accumulate_kernel", "blend kernel")])
def test_kernel_groups(name, group):
    assert trace.group_of(name) == group


@pytest.mark.parametrize("seed,stream,n", [(0, 0, 9), (2 ** 32 - 1, 7, 1001),
                                           (123456789, 33, 4096)])
def test_counter_hash_matches_the_port(seed, stream, n):
    dropout = importlib.import_module("vnet_tpu_torch.ops.dropout")
    thr, _, _ = dropout.dropout_params(0.3, "xla")
    assert philox.threshold(0.3) == thr
    got = philox.keep_mask((n,), seed, stream, 0.3)
    assert torch.equal(got, dropout.keep_mask(n, seed, stream, thr))


def test_p95_is_numpys():
    vals = list(np.random.default_rng(0).random(23))
    assert trace.quantile_p95(vals) == pytest.approx(np.percentile(vals, 95))
    assert trace.quantile_p95([]) is None
