"""The share of the traced window in which no operation ran on the card:
one minus the union of the device events' intervals over the window."""


def read(r):
    if not r.device or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
