"""Device ms a training step of the window-attention kernels, found by the
``swin_wattn_`` that starts their names (forward, backward, the bias
gradient's partials and sum); nothing where the trace has none."""

FRAGMENT = "swin_wattn_"


def read(r):
    ms, n = r.name_ms(FRAGMENT)
    if not n or not r.steps:
        return None
    return ms / r.steps
