"""The window-attention kernels' share of their roofline: the least time
their work needs (each call the longer of its operations at the bf16 peak
and its bytes at the HBM rate, ``reference/swin_unetr_btcv.py::
attention_step``: forward ``4 N d`` operations a query row and head, q, k,
v read and O and the log-sum-exp written once; backward ``8 N d``, q, k,
v, O, dO and the log-sum-exp read and dq, dk, dv written once; the
forward twice a step under ``Remat``) over the device time of every
``swin_wattn_`` kernel.

The counts are those of the one cell this metric lists (``CELL``: its
configuration's batch, frozen patch and ``Remat``). The reading holds them
to the run it reads: nothing where the run's model FLOPs (``work["flops"]``)
are not ``CELL``'s network at ``CELL``'s batch and patch for the steps
read, or where the trace's forward launches are not the count's."""

import math

from portbench import spec
from portbench.yardstick import flops

CELL = "swin_unetr_btcv.train_96_b8_remat"


def read(r):
    ms, n = r.name_ms("swin_wattn_")
    _, fwd = r.name_ms("swin_wattn_fwd")
    if not n or not r.steps or ms <= 0:
        return None
    cell = spec.load_cell(CELL)
    s = cell.settings
    ref = cell.reference()
    model = r.steps * flops.train_step(ref.flops_per_voxel(s["network"]),
                                       s["batch"], s["patch"])
    if not math.isclose(r.work.get("flops", 0.0), model, rel_tol=1e-9):
        return None
    work = ref.attention_step(s["batch"], s["network"])
    if fwd != work["fwd_launches"] * r.steps:
        return None
    return 100.0 * work["bound_s"] * r.steps / (ms / 1e3)
