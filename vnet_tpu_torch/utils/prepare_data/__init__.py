"""Dataset preparation: the port's copy of ``vnet_tpu/utils/prepare_data``."""

from .prepare import (binarize_labels, check_header_consistency,
                      fit_label_crop, lits_restructure, partition_z,
                      unify_header, unzip_adam)

__all__ = [
    "binarize_labels", "check_header_consistency", "fit_label_crop",
    "lits_restructure", "partition_z", "unify_header", "unzip_adam",
]
