"""Plain neighbourhood geometry: squared distances, farthest point
sampling, the ball query, 3-NN interpolation plans and the dense dilated
kNN graphs, written from the published semantics
(``pointnet_util.py`` of Pointnet_Pointnet2_pytorch; ``gcn_lib/dense/
torch_edge.py`` of deep_gcns_torch) in plain tensor operations: every
selection is a stable sort, ties go to the lower index.
"""

from __future__ import annotations

import torch


def sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ_c x_c² over the last axis as a chain of fused multiply-adds in
    channel order, fma(x₂, x₂, fma(x₁, x₁, x₀·x₀)): each step in float64
    (a float32 square is exact there) rounded once to float32."""
    acc = x[..., 0] * x[..., 0]
    wide = x.double()
    for c in range(1, x.shape[-1]):
        xc = wide[..., c]
        acc = torch.addcmul(acc.double(), xc, xc).float()
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, M, C] → [B, N, M] float32, associated as
    (|s|² − 2·s·dᵀ) + |d|², the cross term a float32 batched product."""
    cross = torch.bmm(src, dst.transpose(1, 2)).float()
    src_sq = sum_sq(src.float())
    dst_sq = src_sq if src is dst else sum_sq(dst.float())
    return (src_sq[:, :, None] - 2.0 * cross) + dst_sq[:, None, :]


def smallest(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of the last axis, ascending, ties to the
    lower index (a stable sort cut to k; copies, which free the sort)."""
    v, i = torch.sort(vals, dim=-1, stable=True)
    return v[..., :k].contiguous(), i[..., :k].contiguous()


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] → [B, ..., C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """[B, N, 3] → [B, npoint] indices, from index 0: each step keeps every
    point's least squared distance to the chosen set, ((dx² + dy²) + dz²),
    and takes the first point of the largest."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    least = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    for j in range(npoint):
        out[:, j] = far
        if j == npoint - 1:
            break
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        least = torch.minimum(least, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(least, dim=-1)
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centers: torch.Tensor) -> torch.Tensor:
    """[B, S, nsample]: the lowest-index ``nsample`` points within
    ``radius`` of each centre (squared distance ≤ radius²), the first of
    them repeated where fewer are inside."""
    N = xyz.shape[1]
    d = square_distance(centers, xyz)
    order = torch.arange(N, dtype=torch.float32, device=xyz.device)
    keyed = torch.where(d > radius * radius, float(N), order)
    group = smallest(keyed, nsample)[0].long()
    return torch.where(group == N, group[:, :, :1], group)


def three_nn(dst: torch.Tensor, src: torch.Tensor):
    """The 3 nearest ``src`` points of each ``dst`` point and their
    weights 1/(d² + 1e-8), normalised as 1 / (a · Σ 1/a)."""
    d = square_distance(dst, src)
    _, idx = smallest(d, 3)
    shifted = torch.gather(d, -1, idx) + 1e-8
    return idx, 1.0 / (shifted * torch.sum(1.0 / shifted, dim=-1, keepdim=True))


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, N, C] → [B, N, k]: each point's k nearest points of the same
    cloud in feature space, itself included, nearest first."""
    x = x.detach().float().contiguous()
    return smallest(square_distance(x, x), k)[1]


def dilated_knn_graph(x: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """Every ``dilation``-th of the k·dilation nearest (``DenseDilated``,
    not stochastic)."""
    return knn_graph(x, k * dilation)[..., ::dilation].contiguous()
