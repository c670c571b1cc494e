"""The dropout kernel's share of its roofline: the bytes its launches must
move (``yardstick.nbytes.dropout_launch``: input read once, output written
once, counted at the network's dropout layers) over their summed device
time at the HBM rate. Nothing where the trace's launches are not the ones
counted."""

from portbench.yardstick.peaks import HBM_BYTES_PER_S


def read(r):
    ms, n = r.name_ms("dropout_kernel")
    if not n or n != r.work.get("dropout_launches"):
        return None
    return 100.0 * r.work["dropout_bytes"] / (ms / 1e3 * HBM_BYTES_PER_S)
