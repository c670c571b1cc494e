"""Hand-written Hopper kernels of the port, with their plain versions, the
BatchNorm built on two of them, and the training path's plain PyTorch ops
(``losses``, ``metrics``)."""

from .batchnorm import batch_norm_train
from .blend import (blend_accumulate_patches, blend_accumulate_plain,
                    blend_accumulate_rows, blend_accumulate_rows_plain)
from .dropout import dropout, dropout_apply, dropout_plain
from .dw_conv import conv3d_dw, dw_conv, dw_conv_plain
from .fused import (bn_grad_stats, bn_grad_stats_plain, bn_stats,
                    bn_stats_plain, fused_bias_prelu_residual,
                    fused_bias_prelu_residual_plain)

__all__ = ["batch_norm_train", "blend_accumulate_patches",
           "blend_accumulate_plain", "blend_accumulate_rows",
           "blend_accumulate_rows_plain", "bn_grad_stats",
           "bn_grad_stats_plain", "bn_stats", "bn_stats_plain", "dropout",
           "dropout_apply", "dropout_plain", "conv3d_dw", "dw_conv",
           "dw_conv_plain", "fused_bias_prelu_residual",
           "fused_bias_prelu_residual_plain"]
