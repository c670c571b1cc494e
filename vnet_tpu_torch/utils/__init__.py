"""Host utilities of the port — counterpart of ``vnet_tpu/utils``: the
synthetic-data generator (``synthdata``), the checkpoint x stride grid
search (``batch_evaluate``), bounding boxes (``bbox``) and dataset
preparation (``prepare_data``). ``batch_evaluate``, ``bbox`` and
``prepare_data`` are also command lines (``python -m
vnet_tpu_torch.utils.<name>``). The names below load their module on first
use, so that running a module with ``-m`` does not import it twice.
"""

import importlib

_EXPORTS = {
    "BatchEvaluate": "batch_evaluate", "GridResult": "batch_evaluate",
    "lesion_detection": "batch_evaluate",
    "lesion_volume_buckets": "batch_evaluate",
    "overlap_measures": "batch_evaluate",
    "Box": "bbox", "nms": "bbox", "render_slice": "bbox",
    "slice_boxes": "bbox", "volume_boxes": "bbox",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
