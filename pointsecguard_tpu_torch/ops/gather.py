"""Batched index gathers (port of ``pointsecguard_tpu/ops/gather.py``)."""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather per-batch point rows by index.

    Args:
      points: [B, N, C] point features.
      idx: [B, ...] integer indices into the N axis (any trailing shape).

    Returns:
      [B, ..., C] gathered features.
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    out = torch.gather(points, 1, flat)
    return out.reshape(*idx.shape, C)
