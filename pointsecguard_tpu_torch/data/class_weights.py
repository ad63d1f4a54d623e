"""Per-dataset class weights (`RandLA-Net/helper_tool.py:245-261`; a copy
of ``pointsecguard_tpu/data/class_weights.py``).

The reference hard-codes the per-class point counts of each dataset and
derives cross-entropy weights as ``1 / (freq + 0.02)``.
"""

from __future__ import annotations

import numpy as np

# `helper_tool.py:249-258` — pre-calculated per-class point counts
NUM_PER_CLASS = {
    "S3DIS": np.array(
        [3370714, 2856755, 4919229, 318158, 375640, 478001, 974733,
         650464, 791496, 88727, 1284130, 229758, 2272837],
        np.int64,
    ),
    "Semantic3D": np.array(
        [5181602, 5012952, 6830086, 1311528, 10476365, 946982, 334860,
         269353],
        np.int64,
    ),
    "SemanticKITTI": np.array(
        [55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
         240942562, 17294618, 170599734, 6369672, 230413074, 101130274,
         476491114, 9833174, 129609852, 4506626, 1168181],
        np.int64,
    ),
}


def class_weights_from_counts(counts: np.ndarray) -> np.ndarray:
    """``1 / (class_frequency + 0.02)`` (`helper_tool.py:259-261`)."""
    freq = np.asarray(counts, np.float64) / float(np.sum(counts))
    return (1.0 / (freq + 0.02)).astype(np.float32)


def get_class_weights(dataset_name: str) -> np.ndarray:
    """Reference-identical CE weights for a named dataset."""
    return class_weights_from_counts(NUM_PER_CLASS[dataset_name])
