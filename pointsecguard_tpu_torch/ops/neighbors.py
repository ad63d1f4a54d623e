"""Neighbourhood search (port of ``pointsecguard_tpu/ops/neighbors.py``):
exact kNN, ``repeat_pad_k`` and the ball query.

The dilated kNN graphs serve ResGCN and are not ported yet.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel
from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    k: int,
    *,
    tile: int | None = None,
    strategy: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query point among ``points``.

    Args:
      query: [B, S, C] query positions.
      points: [B, N, C] reference positions.
      k: number of neighbours (1 ≤ k ≤ 48 on the fused route).
      tile: on the "pallas" route, the query rows per distance block,
        bounding the [B, tile, N] working set (the fused kernel never
        writes that matrix and ignores it).
      strategy: "auto" or "fused" — the fused kNN kernel
        (``ops/cuda/knn.py``; its plain version for a CPU tensor);
        "pallas" — ``square_distance`` then exact kernel selection
        (``bottom_k_indices``: wide rows go to the wide-row kernel), the
        JAX package's name for that route. The JAX opt-in strategies
        (approx, iterative, twostage, topk) are not ported.

    Returns:
      (sq_dists [B, S, k] float32, idx [B, S, k] int32), nearest first,
      ties to the first occurrence; both routes give the same result.
    """
    # selection runs in float32 whatever the model dtype (bf16 distances
    # would flip near-tie neighbours)
    query = query.float()
    points = points.float()
    if strategy in ("auto", "fused"):
        return knn_kernel.knn(query, points, k)
    if strategy != "pallas":
        raise ValueError(f"knn: strategy {strategy!r} not ported yet "
                         "(auto | fused | pallas)")
    if tile is None or tile >= query.shape[1]:
        return bottom_k_indices(square_distance(query, points), k)
    parts = [bottom_k_indices(square_distance(query[:, s : s + tile], points), k)
             for s in range(0, query.shape[1], tile)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def repeat_pad_k(idx: torch.Tensor, k: int) -> torch.Tensor:
    """Pad a [..., S, k_eff] neighbour list to k columns by repeating the
    list in order (or truncate if wider): the tiny-cloud semantics of
    RandLA's pyramid, where a level with fewer than k points repeats its
    nearest neighbours cyclically."""
    k_eff = idx.shape[-1]
    if k_eff >= k:
        return idx[..., :k]
    reps = -(-k // k_eff)
    return idx.repeat(*([1] * (idx.dim() - 1)), reps)[..., :k]


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
