"""Whole-scene voting evaluation (port of
``pointsecguard_tpu/train/evaluator.py:20-103``, the reference's
`test_semseg.py:85-189`).

Per room: cut stride-0.5 sliding blocks, run the forward over fixed-size
batches, accumulate one-hot votes into a per-point pool, argmax the pool,
and fold the room into a global confusion matrix. The attack CLI uses
``add_votes`` to pool clean and adversarial predictions per room.
"""

from __future__ import annotations

import os

from typing import Callable

import numpy as np

from pointsecguard_tpu_torch.data.s3dis import NUM_CLASSES, RoomSet, WholeSceneBlocks
from pointsecguard_tpu_torch.utils.metrics import SegMetrics, metrics_from_confusion


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


def evaluate_whole_scenes(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    rooms: RoomSet,
    *,
    batch_size: int = 16,
    num_votes: int = 1,
    block_points: int = 4096,
    rng: np.random.Generator | None = None,
    num_classes: int = NUM_CLASSES,
    visual_dir: str | None = None,
) -> tuple[SegMetrics, list[SegMetrics]]:
    """Evaluate every room of ``rooms`` with vote pooling.

    Args:
      predict_fn: points [B, P, 9] → predicted labels [B, P]
        (``train.trainer.make_eval_step``). Every call gets ``batch_size``
        blocks: the last chunk of a room is padded with all-zero blocks,
        whose predictions are dropped.
      visual_dir: if set, write each room's predicted and ground-truth
        label clouds (``.xyzrgb``) and the predictions' HTML viewer there:
        the reference test script's ``--visual`` artifacts
        (`test_semseg.py:101-174`).

    Returns:
      (dataset-level metrics, per-room metrics) — both confusion-based.
    """
    rng = rng or np.random.default_rng(0)
    ws = WholeSceneBlocks(rooms, block_points=block_points)
    total_cm = np.zeros((num_classes, num_classes), np.float64)
    per_room = []
    for room_idx in range(len(ws)):
        labels_room = rooms.labels[room_idx]
        vote_pool = np.zeros((len(labels_room), num_classes), np.float64)
        for _ in range(num_votes):
            data, labels, weights, pidx = ws.room_blocks(room_idx, rng)
            nb = data.shape[0]
            for start in range(0, nb, batch_size):
                end = min(start + batch_size, nb)
                chunk = data[start:end]
                if chunk.shape[0] < batch_size:  # pad to the fixed batch
                    pad = batch_size - chunk.shape[0]
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                    )
                preds = np.asarray(predict_fn(chunk))[: end - start]
                vote_pool = add_votes(
                    vote_pool, pidx[start:end], preds, weights[start:end]
                )
        room_pred = np.argmax(vote_pool, axis=1)
        if visual_dir is not None:
            from pointsecguard_tpu_torch.utils.logging import write_label_cloud
            from pointsecguard_tpu_torch.utils.viz import export_html_viewer

            os.makedirs(visual_dir, exist_ok=True)
            xyz = rooms.points[room_idx][:, :3]
            base = os.path.join(visual_dir, rooms.names[room_idx])
            write_label_cloud(base + "_pred.xyzrgb", xyz, room_pred)
            write_label_cloud(base + "_gt.xyzrgb", xyz, labels_room)
            export_html_viewer(base + "_pred.html", xyz, labels=room_pred,
                               title=f"{rooms.names[room_idx]} predictions")
        cm = np.zeros((num_classes, num_classes), np.float64)
        np.add.at(cm, (labels_room, room_pred), 1.0)
        total_cm += cm
        per_room.append(metrics_from_confusion(cm))
    return metrics_from_confusion(total_cm), per_room
