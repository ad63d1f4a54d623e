"""Segmentation metrics from a confusion matrix, numpy (port of
``pointsecguard_tpu/utils/metrics.py:18-61``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def confusion_matrix(
    labels: np.ndarray,
    preds: np.ndarray,
    num_classes: int,
    *,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """[C, C] float32 confusion matrix (rows ground truth, columns
    prediction); ``valid`` weights out padding points."""
    y = np.asarray(labels).reshape(-1).astype(np.int64)
    p = np.asarray(preds).reshape(-1).astype(np.int64)
    w = None if valid is None else np.asarray(valid).reshape(-1).astype(np.float32)
    flat = np.bincount(y * num_classes + p, weights=w,
                       minlength=num_classes * num_classes)
    return flat.astype(np.float32).reshape(num_classes, num_classes)


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
