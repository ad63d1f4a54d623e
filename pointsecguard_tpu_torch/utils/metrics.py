"""Segmentation metrics from a confusion matrix, numpy (port of
``pointsecguard_tpu/utils/metrics.py:49-61``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SegMetrics(NamedTuple):
    accuracy: float  # overall point accuracy
    class_iou: np.ndarray  # [C] per-class IoU (0 where the class is unseen)
    miou: float  # mean IoU over classes present in GT or prediction
    class_seen: np.ndarray  # [C] bool — class participates in the mean


def metrics_from_confusion(cm: np.ndarray) -> SegMetrics:
    """IoU family from a [C, C] confusion matrix (rows ground truth), with
    `helper_tool.py:218-243` semantics: classes absent from both GT and
    prediction are left out of the mean."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    gt = cm.sum(axis=1)
    pred = cm.sum(axis=0)
    union = gt + pred - tp
    seen = union > 0
    iou = np.where(seen, tp / np.maximum(union, 1e-12), 0.0)
    miou = float(iou.sum() / max(float(seen.sum()), 1.0))
    acc = float(tp.sum() / max(float(cm.sum()), 1.0))
    return SegMetrics(acc, iou, miou, seen)
