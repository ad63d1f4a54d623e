"""Ball query (port of ``pointsecguard_tpu/ops/neighbors.py:146-179``).

kNN, the dilated graphs and ``repeat_pad_k`` serve RandLA-Net and ResGCN
and are not ported yet.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices


def ball_query(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Fixed-radius neighbourhoods with the reference's exact semantics.

    Matches `pointnet_util.py:87-107`: candidates are points with squared
    distance ≤ radius²; the *lowest-index* ``nsample`` candidates are kept
    (index-sorted, not distance-sorted), and groups with fewer than
    ``nsample`` candidates repeat the first one. Computed as a bottom-k
    over index values (out-of-radius points carry the sentinel N).

    Args:
      radius: ball radius.
      nsample: group size.
      xyz: [B, N, 3] all points.
      new_xyz: [B, S, 3] query centres.

    Returns:
      [B, S, nsample] int32 group indices.
    """
    N = xyz.shape[1]
    sqr = square_distance(new_xyz, xyz)  # [B, S, N]
    arange = torch.arange(N, dtype=torch.float32, device=xyz.device)
    idx_val = torch.where(sqr > radius * radius, float(N), arange)
    if nsample > N:  # degenerate tiny clouds: pad candidates with sentinel N
        pad = idx_val.new_full((*idx_val.shape[:2], nsample - N), float(N))
        idx_val = torch.cat([idx_val, pad], dim=-1)
    group_val, _ = bottom_k_indices(idx_val, nsample)
    group_idx = group_val.to(torch.int32)
    first = group_idx[:, :, :1]
    return torch.where(group_idx == N, first, group_idx)
