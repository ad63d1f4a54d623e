"""3-NN inverse-distance interpolation and RandLA's nearest upsampling
(port of ``pointsecguard_tpu/ops/interpolate.py:18-50,66-78``)."""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.gather import gather_points
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices


def three_nn_plan(
    xyz_dst: torch.Tensor, xyz_src: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """3 nearest source points per destination point and their weights
    ∝ 1/(d² + 1e-8), normalised (`pointnet_util.py:298-308`).

    Args:
      xyz_dst: [B, N, 3] destination (dense) positions.
      xyz_src: [B, S, 3] source (sparse) positions.

    Returns:
      (idx [B, N, 3] int32, weight [B, N, 3] float32).
    """
    d = square_distance(xyz_dst, xyz_src)  # [B, N, S]
    dists, idx = bottom_k_indices(d, 3)
    recip = 1.0 / (dists + 1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    return idx, weight


def apply_three_nn(
    feats_src: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Gather + weighted-sum half of the 3-NN interpolation → [B, N, D]."""
    gathered = gather_points(feats_src, idx)  # [B, N, 3, D]
    return torch.sum(gathered * weight[..., None], dim=2)


def nearest_upsample(feats: torch.Tensor, interp_idx: torch.Tensor) -> torch.Tensor:
    """1-NN feature copy to a denser set (RandLA `nearest_interpolation`).

    Args:
      feats: [B, S, D] source features.
      interp_idx: [B, N, 1] (or [B, N]) nearest source index per dense point.

    Returns:
      [B, N, D].
    """
    if interp_idx.dim() == 3:
        interp_idx = interp_idx[..., 0]
    return gather_points(feats, interp_idx)
