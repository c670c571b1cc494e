"""Hand-written Hopper kernels of the port, with their plain versions, and
the training path's plain PyTorch ops (``losses``, ``metrics``)."""

from .blend import blend_accumulate_patches, blend_accumulate_plain
from .dropout import dropout, dropout_apply, dropout_plain
from .dw_conv import conv3d_dw, dw_conv, dw_conv_plain

__all__ = ["blend_accumulate_patches", "blend_accumulate_plain", "dropout",
           "dropout_apply", "dropout_plain", "conv3d_dw", "dw_conv",
           "dw_conv_plain"]
