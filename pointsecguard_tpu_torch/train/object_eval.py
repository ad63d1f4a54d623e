"""Evaluation of the object-task models (port of
``pointsecguard_tpu/train/object_eval.py:21-130``): instance and mean
per-class accuracy of the classifiers on ModelNet, and the instance and
class-averaged part mIoU of the part-segmentation nets on ShapeNetPart,
the standard protocols the reference's models were trained with upstream.

Batches have a fixed size: the tail is filled up with shape 0, and the
filling is left out of the metrics.
"""

from __future__ import annotations

import numpy as np

from pointsecguard_tpu_torch.data.shapenet_part import SEG_CLASSES


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


def _restricted_argmax(logp: np.ndarray, category: str) -> np.ndarray:
    """[N] part predictions of one shape, the argmax over its category's
    parts only (the upstream protocol)."""
    parts = SEG_CLASSES[category]
    return np.array(parts)[np.asarray(logp)[:, parts].argmax(axis=-1)]


def shape_part_ious(logp: np.ndarray, seg: np.ndarray, category: str) -> list[float]:
    """Per-part IoUs of one shape ([N, 50] log-probabilities, [N] labels):
    the argmax restricted to the category's parts; a part absent from both
    the labels and the prediction scores IoU 1."""
    pred = _restricted_argmax(logp, category)
    ious = []
    for p in SEG_CLASSES[category]:
        inter = ((seg == p) & (pred == p)).sum()
        union = ((seg == p) | (pred == p)).sum()
        ious.append(1.0 if union == 0 else float(inter) / float(union))
    return ious


def evaluate_partseg(predict_logp, dataset, *, batch_size: int = 8,
                     num_object_classes: int = 16) -> dict:
    """→ {"instance_miou", "class_avg_miou", "accuracy", "category_miou":
    {category: mIoU}}.

    ``predict_logp(points [B, N, C], one-hot [B, 16]) → [B, N, 50]``
    log-probabilities (numpy or a CPU tensor). Each shape's points are its
    file's rows in order, repeated to fill up (``dataset.load(i)``), the
    analogue of the upstream fixed-seed test pass."""
    shape_miou: dict[str, list[float]] = {}
    correct = total = 0
    for idx, n_valid in _padded_batches(len(dataset), batch_size):
        loaded = [dataset.load(i) for i in idx]
        pts = np.stack([l[0] for l in loaded])
        onehot = np.eye(num_object_classes, dtype=np.float32)[[l[1] for l in loaded]]
        logp = np.asarray(predict_logp(pts, onehot))
        for j in range(n_valid):
            cat, seg = dataset.categories[idx[j]], loaded[j][2]
            shape_miou.setdefault(cat, []).append(
                float(np.mean(shape_part_ious(logp[j], seg, cat))))
            correct += int((_restricted_argmax(logp[j], cat) == seg).sum())
            total += seg.size
    cat_miou = {c: float(np.mean(v)) for c, v in sorted(shape_miou.items())}
    all_shapes = [m for v in shape_miou.values() for m in v]
    return {"instance_miou": float(np.mean(all_shapes)) if all_shapes else 0.0,
            "class_avg_miou": float(np.mean(list(cat_miou.values()))) if cat_miou else 0.0,
            "accuracy": correct / total if total else 0.0,
            "category_miou": cat_miou}
