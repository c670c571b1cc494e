"""Published peaks of one NVIDIA H100 SXM (dense rates, at the full 700 W
power limit): the denominators of every ``mfu`` and roofline share."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
