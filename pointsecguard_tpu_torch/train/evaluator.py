"""Whole-scene vote pooling (port of ``pointsecguard_tpu/train/evaluator.py:20-34``).

The voting evaluation loop itself is not ported yet; the attack CLI
uses ``add_votes`` to pool clean and adversarial predictions per room.
"""

from __future__ import annotations

import numpy as np


def add_votes(
    vote_pool: np.ndarray,
    point_idx: np.ndarray,
    pred_label: np.ndarray,
    weight: np.ndarray,
) -> np.ndarray:
    """Scatter one-hot votes (`test_semseg.py:37-44`: a vote counts
    wherever the sample weight is nonzero)."""
    sel = weight.reshape(-1) != 0
    np.add.at(
        vote_pool,
        (point_idx.reshape(-1)[sel], pred_label.reshape(-1)[sel]),
        1.0,
    )
    return vote_pool
