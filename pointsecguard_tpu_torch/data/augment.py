"""Point-cloud augmentation of the semantic-segmentation trainer, numpy
(port of ``pointsecguard_tpu/data/augment.py:14-31``; the same RNG call,
so the same generator state gives the same rotation)."""

from __future__ import annotations

import numpy as np


def rotate_point_cloud_z(
    batch: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Per-cloud random rotation about +z (`provider.py:66-84`)."""
    B = batch.shape[0]
    angles = rng.uniform(0.0, 2 * np.pi, B)
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros(B), np.ones(B)
    # the reference matrix [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    rot = np.stack(
        [
            np.stack([c, s, zeros], -1),
            np.stack([-s, c, zeros], -1),
            np.stack([zeros, zeros, ones], -1),
        ],
        axis=1,
    )
    return np.einsum("bnc,bcd->bnd", batch, rot).astype(np.float32)
