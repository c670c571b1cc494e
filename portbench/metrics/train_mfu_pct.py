"""Model FLOPs of the window's training steps (``yardstick.flops``) over
the window's time at the card's bf16 peak, in percent."""

from portbench.yardstick.peaks import BF16_FLOPS_PER_S


def read(r):
    flops = r.work.get("flops")
    if not flops or r.window_s <= 0:
        return None
    chips = r.work.get("chips", 1)
    return 100.0 * flops / (r.window_s * BF16_FLOPS_PER_S * chips)
