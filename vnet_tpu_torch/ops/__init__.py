"""Hand-written Hopper kernels of the port, with their plain versions."""

from .blend import blend_accumulate_patches, blend_accumulate_plain

__all__ = ["blend_accumulate_patches", "blend_accumulate_plain"]
