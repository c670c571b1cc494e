"""Distance-map supervision targets for the attention gate.

The legacy reference path trains its AttentionModule to regress a distance
map of the label (reference `train.py:383-401`); the shipped dataset
copy lost the distmap generation (SURVEY.md §3.3 — treat the feature spec,
not the bit-rotted code, as the target). Definition used here: Euclidean
distance transform *inside* the foreground, normalized to [0, 1] by its
maximum — 1 at object cores, 0 at boundaries/background, matching the
"attention peaks at lesion centres" intent.

The port's copy of ``vnet_tpu/data/distance.py``, equal in behaviour
(``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def distance_map(label: np.ndarray, normalize: bool = True) -> np.ndarray:
    """EDT of the foreground (``label > 0``), float32.

    Empty labels produce an all-zero map.
    """
    mask = label > 0
    if not mask.any():
        return np.zeros(label.shape, np.float32)
    dt = ndimage.distance_transform_edt(mask).astype(np.float32)
    if normalize:
        m = dt.max()
        if m > 0:
            dt /= m
    return dt
