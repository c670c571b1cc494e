"""Inference side of the port: sliding window, post-processing, evaluator."""

from .evaluator import Evaluator
from .postprocess import extract_largest_connected_component, volume_threshold
from .sliding_window import (SlidingWindowInference, build_patch_grid,
                             cosine_window, patch_starts_1d)

__all__ = [
    "Evaluator", "extract_largest_connected_component", "volume_threshold",
    "SlidingWindowInference", "build_patch_grid", "cosine_window",
    "patch_starts_1d",
]
