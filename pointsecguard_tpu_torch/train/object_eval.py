"""Evaluation of the classifiers (port of
``pointsecguard_tpu/train/object_eval.py:21-69``): instance and mean
per-class accuracy on ModelNet, the standard protocol the reference's
classifiers were trained with upstream.

Batches have a fixed size: the tail is filled up with shape 0, and the
filling is left out of the metrics.
"""

from __future__ import annotations

import numpy as np


def _padded_batches(n: int, batch_size: int):
    """(indices [batch_size], number valid) over ``range(n)``; the last
    batch is filled up with index 0 to the fixed size."""
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        n_valid = len(idx)
        if n_valid < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - n_valid, int)])
        yield idx, n_valid


def evaluate_cls(
    predict_logp,
    dataset,
    *,
    batch_size: int = 16,
    num_votes: int = 1,
    rng: np.random.Generator | None = None,
) -> tuple[float, float, np.ndarray]:
    """(instance accuracy, mean per-class accuracy, [n] predictions).

    ``predict_logp(points [B, N, C] numpy) → log-probabilities [B, K]``
    (numpy or a CPU tensor). The votes are pooled in softmax space (the
    upstream ``test_classification`` pool). Vote 0 takes each shape's first
    N points; every later vote draws a fresh random subset through
    ``dataset.load(i, rng)``, so that the votes pool different evidence
    (upstream's extra votes rerun the same forward)."""
    rng = rng or np.random.default_rng(0)
    n = len(dataset)
    preds = np.zeros(n, np.int64)
    labels = np.asarray(dataset.labels, np.int64)
    for idx, n_valid in _padded_batches(n, batch_size):
        votes = 0.0
        for v in range(max(num_votes, 1)):
            pts = np.stack([dataset.load(i, rng if v else None)[0] for i in idx])
            votes = votes + np.exp(np.asarray(predict_logp(pts)))
        take = idx[:n_valid]
        preds[take] = votes[:n_valid].argmax(axis=-1)
    inst_acc = float((preds == labels).mean()) if n else 0.0
    class_accs = [float((preds[labels == c] == c).mean())
                  for c in range(dataset.num_classes) if (labels == c).any()]
    return inst_acc, float(np.mean(class_accs)) if class_accs else 0.0, preds
