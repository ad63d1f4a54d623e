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
      (idx [B, N, 3] int32, weight [B, N, 3] in the inputs' dtype).

    The three distances are gathered from ``d`` at the selected indices:
    the selection runs in float32, so a float64 ``d`` keeps its own values
    (as JAX's ``lax.top_k`` route does), and the weights carry the
    coordinates' gradient through both point sets.
    """
    d = square_distance(xyz_dst, xyz_src)  # [B, N, S]
    _, idx = bottom_k_indices(d.detach(), 3)
    return idx, inverse_distance_weights(torch.gather(d, -1, idx.long()))


def three_nn_weights(xyz_dst: torch.Tensor, xyz_src: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """``three_nn_plan``'s weights at given indices ([B, N, 3]): the plan's
    weight half, differentiable in both point sets."""
    return inverse_distance_weights(
        torch.gather(square_distance(xyz_dst, xyz_src), -1, idx.long()))


def inverse_distance_weights(dists: torch.Tensor) -> torch.Tensor:
    """[..., 3] squared distances → weights ∝ 1 / (d² + 1e-8), normalised."""
    shifted = dists + 1e-8
    # (1/a) / Σ as 1 / (a · Σ): the form XLA's simplifier gives the JAX
    # package's formula, so the weights round as JAX's do
    return 1.0 / (shifted * torch.sum(1.0 / shifted, dim=-1, keepdim=True))


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
