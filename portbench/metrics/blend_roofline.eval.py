"""The blend kernel's share of its roofline: the bytes its launches must
move (``yardstick.nbytes.blend_launch``: the contributions read once, the
accumulator over each batch's patches read and written once) over their
summed device time at the HBM rate. Nothing where the trace's launches are
not one a batch."""

from portbench.yardstick.peaks import HBM_BYTES_PER_S


def read(r):
    ms, n = r.name_ms("blend_accumulate_kernel")
    if not n or n != r.work.get("blend_launches"):
        return None
    return 100.0 * r.work["blend_bytes"] / (ms / 1e3 * HBM_BYTES_PER_S)
