"""Neighbourhood search (port of ``pointsecguard_tpu/ops/neighbors.py``):
exact kNN, ``repeat_pad_k``, the ball query, and ResGCN's dense dilated
kNN graphs (``dense_knn_graph``, ``dilate_neighbors``).
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel
from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices

# JAX's names of its exact selections (``ops/selection.py``): all take the
# exact selection of ``bottom_k_indices`` here
_EXACT_SELECTIONS = ("pallas", "topk", "iterative", "twostage")


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
      strategy: "auto" or "fused": the fused kNN kernel
        (``ops/cuda/knn.py``; its plain version for a CPU tensor);
        "approx": the same kernel (JAX's ``lax.approx_max_k``, which on
        the CPU returns ``lax.top_k``'s indices; here it is exact
        everywhere), above the kernel's k through the exact selection;
        "pallas": ``square_distance`` then exact kernel selection
        (``bottom_k_indices``: wide rows go to the wide-row kernel), the
        JAX package's name for that route, and so are JAX's exact
        selections "topk", "iterative" and "twostage".

    Returns:
      (sq_dists [B, S, k] float32, idx [B, S, k] int32), nearest first,
      ties to the first occurrence; every route gives the same result.
    """
    # selection runs in float32 whatever the model dtype (bf16 distances
    # would flip near-tie neighbours)
    query = query.float()
    points = points.float()
    if strategy == "approx":
        strategy = "auto" if k <= knn_kernel.MAX_K else "pallas"
    if strategy in ("auto", "fused"):
        return knn_kernel.knn(query, points, k)
    if strategy not in _EXACT_SELECTIONS:
        raise ValueError(f"knn: unknown strategy {strategy!r} (auto | fused | approx | "
                         + " | ".join(_EXACT_SELECTIONS) + ")")
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


def dense_knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN graph over feature space (ResGCN `dense_knn_matrix:45-59`).

    Routed as the JAX package routes it (``_use_fused_knn``): k ≤ 48 goes
    to the fused kNN kernel (``ops/cuda/knn.py``; its plain version for a
    CPU tensor), larger k to ``square_distance`` and the stable sort of
    ``bottom_k_indices`` (JAX sends it to ``lax.top_k``, an XLA sort).
    The graph is built from ``x.detach()``: it is integer indices and
    carries no gradient, so autograd keeps nothing of the [B, N, N]
    distances.

    Args:
      x: [B, N, C] features.
      k: neighbours per node.

    Returns:
      [B, N, k] int32 neighbour indices, nearest first, ties to the lower
      index; the point itself is included, as in the reference's topk
      over the full distance row.
    """
    x = x.detach().float().contiguous()
    strategy = "auto" if k <= knn_kernel.MAX_K else "pallas"
    return knn(x, x, k, strategy=strategy)[1]


def dilate_neighbors(
    idx: torch.Tensor,
    dilation: int,
    *,
    stochastic: bool = False,
    epsilon: float = 0.0,
    generator: torch.Generator | None = None,
    draws: tuple | None = None,
) -> torch.Tensor:
    """Dilated neighbour selection (ResGCN `DenseDilated:6-29`).

    Given [B, N, k·dilation] candidates, keep every ``dilation``-th, or,
    with probability ``epsilon`` in stochastic training, one random subset
    of k columns for the whole batch. The draw is ``draws = (u, perm)`` (u
    a uniform scalar, perm the column order) where given, else taken from
    ``generator``; with neither, or not ``stochastic``, the strided
    selection. The draws cannot equal ``jax.random``'s: the two agree in
    distribution only.
    """
    k = idx.shape[-1] // max(dilation, 1)
    strided = idx[..., ::dilation] if dilation > 1 else idx
    if not stochastic or (draws is None and generator is None):
        return strided
    if draws is None:
        dev = generator.device
        draws = (torch.rand((), generator=generator, device=dev),
                 torch.randperm(idx.shape[-1], generator=generator, device=dev))
    u, perm = draws
    random_sel = idx[..., torch.as_tensor(perm, device=idx.device)[:k]]
    return torch.where(torch.as_tensor(u, device=idx.device) < epsilon, random_sel, strided)
