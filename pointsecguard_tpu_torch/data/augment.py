"""Point-cloud augmentation, numpy (port of
``pointsecguard_tpu/data/augment.py:14-31,63-94``): the semantic-
segmentation trainer's z rotation, and the classification trainer's
random point dropout, scale and shift. The same RNG calls, so the same
generator state gives the same augmentation."""

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


def shift_point_cloud(
    batch: np.ndarray, rng: np.random.Generator, shift_range: float = 0.1
) -> np.ndarray:
    """Per-cloud uniform translation (`provider.py:214-226`)."""
    shifts = rng.uniform(-shift_range, shift_range, (batch.shape[0], 1, 3))
    return (batch + shifts).astype(np.float32)


def random_scale_point_cloud(
    batch: np.ndarray,
    rng: np.random.Generator,
    scale_low: float = 0.8,
    scale_high: float = 1.25,
) -> np.ndarray:
    """Per-cloud uniform scale (`provider.py:228-239`)."""
    scales = rng.uniform(scale_low, scale_high, (batch.shape[0], 1, 1))
    return (batch * scales).astype(np.float32)


def random_point_dropout(
    batch: np.ndarray, rng: np.random.Generator, max_dropout_ratio: float = 0.875
) -> np.ndarray:
    """Per-cloud random dropout; dropped points collapse onto the first
    point (`provider.py:241-249`)."""
    out = batch.copy()
    for b in range(batch.shape[0]):
        ratio = rng.random() * max_dropout_ratio
        drop = rng.random(batch.shape[1]) <= ratio
        out[b, drop] = out[b, 0]
    return out
