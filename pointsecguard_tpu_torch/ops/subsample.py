"""Grid subsampling (voxel-grid barycenter pooling), numpy only (a copy
of ``pointsecguard_tpu/ops/subsample.py:18-63``).

Host-side preprocessing equivalent of the reference's C++ hash-grid
subsampler (`RandLA-Net/utils/cpp_wrappers/cpp_subsampling/grid_subsampling/
grid_subsampling.cpp:5-106`): points falling in the same ``sampleDl`` voxel
are averaged (barycenter of coordinates and features); labels are decided
by majority vote. This runs once during dataset preparation, not in the
hot path. The JAX package's optional C++ route (``data/native.py``) is
not copied: this numpy version is the one the port uses.
"""

from __future__ import annotations

import numpy as np


def grid_subsample(
    points: np.ndarray,
    features: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    sample_dl: float = 0.1,
    num_classes: int | None = None,
):
    """Voxel-grid barycenter subsampling.

    Args:
      points: [N, 3] float coordinates.
      features: optional [N, F].
      labels: optional [N] int.
      sample_dl: voxel edge length.
      num_classes: optional label-count hint for the majority vote.

    Returns:
      (sub_points, [sub_features], [sub_labels]) — only provided arrays are
      returned, in the same order as the reference wrapper
      (`cpp_subsampling/wrapper.cpp`).
    """
    points = np.asarray(points, np.float32)
    origin = points.min(axis=0)
    vox = np.floor((points - origin) / sample_dl).astype(np.int64)
    # Dense ravel of voxel coordinates -> unique cell ids.
    dims = vox.max(axis=0) + 1
    cell = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    uniq, inv, counts = np.unique(cell, return_inverse=True, return_counts=True)
    n_cells = uniq.shape[0]

    def _mean(arr):
        out = np.zeros((n_cells, arr.shape[1]), np.float64)
        np.add.at(out, inv, arr)
        return (out / counts[:, None]).astype(np.float32)

    sub_points = _mean(points)
    result = [sub_points]
    if features is not None:
        result.append(_mean(np.asarray(features, np.float32)))
    if labels is not None:
        labels = np.asarray(labels).astype(np.int64)
        C = int(num_classes) if num_classes else int(labels.max()) + 1
        hist = np.zeros((n_cells, C), np.int64)
        np.add.at(hist, (inv, labels), 1)
        result.append(hist.argmax(axis=1).astype(np.int32))
    return tuple(result) if len(result) > 1 else result[0]
