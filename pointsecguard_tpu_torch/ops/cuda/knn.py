"""Exact kNN fused with its distance: CUDA kernel 4 and its plain version.

Replaces ``pointsecguard_tpu/ops/pallas/knn.py:_knn_kernel`` (entry point
``knn_pallas``). ``csrc/knn.cu`` holds two kernels; the [S, N] distance
matrix reaches device memory in neither.

- D = 3 (RandLA's pyramid, ResGCN's head graph): one thread per query
  streams the points, packed as (x, y, z, |p|²), through shared memory and
  keeps a sorted list of its k best (value, index) pairs in registers.
  Bounded by operations, first by the shared-memory load that brings each
  point to a warp. Its hot loop is arithmetic only (groups of independent
  distance chains, one warp vote a group); candidates wait in a per-thread
  queue and are inserted by all lanes of a warp together.
- Any other D (ResGCN's feature-space graphs): a block of 128 queries walks
  the points in tiles of 64. It forms each tile's [128, 64] block of cross
  terms as an SGEMM micro-tile in registers (8 × 8 a thread, four 16-byte
  shared loads a coordinate for 64 FMAs) from queries and points staged
  transposed in chunks of 16 coordinates, writes the block's distances to
  shared memory, and each thread then selects from its query's row: the
  points below its k-th value at the tile's start, walked by the lanes of a
  warp together. Bounded by the float32 FMA rate.

Both leave values, indices and tie order as point-by-point insertion gives
them. The kernels' bounds: float32, 1 ≤ D ≤ 4096, 1 ≤ k ≤ 48, k ≤ N,
B ≤ 65535 (the plain version takes any D).

Contract (both versions): (sq_dists [B, S, k] float32, idx [B, S, k]
int32), nearest first, ties to the first occurrence — ``square_distance``
followed by a stable sort cut to k. The kernels round each distance as
``square_distance`` does: |q|² and |p|² with ``_sum_sq``'s own roundings
(small kernels of the same file compute them into the working space the
wrapper allocates), the cross term as the fused multiply-add chain a
float32 GEMM accumulates, in coordinate order, with no TF32 or tensor
core. ``knn`` calls the custom op ``psg::knn`` (``library.py``): the
dispatcher launches the kernel for a CUDA tensor, which raises when the
kernel cannot take it; only a CPU tensor goes to ``knn_plain``. Neither
carries a gradient (JAX's ``stop_gradient``).
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.distance import square_distance

MAX_K = 48
MAX_D = 4096  # the kernels' widest D (csrc/knn.cu kMaxD); the plain version takes any
PLAIN_TILE = 4096  # query rows per distance block of the plain version
launches = 0  # kernel launches by ``psg::knn``; never the plain version or a trace


def knn_plain(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``square_distance`` per block of ``PLAIN_TILE`` queries, then the
    stable sort cut to k (the [B, tile, N] block bounds the working set)."""
    vals, idx = [], []
    for s in range(0, query.shape[1], PLAIN_TILE):
        d = square_distance(query[:, s : s + PLAIN_TILE], points)
        v, i = torch.sort(d, dim=-1, stable=True)
        # copies, so that no block's whole sorted row outlives the loop
        vals.append(v[..., :k].clone())
        idx.append(i[..., :k].to(torch.int32))
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def check_args(query: torch.Tensor, points: torch.Tensor, k: int) -> None:
    if query.dim() != 3 or points.dim() != 3 or query.shape[0] != points.shape[0] \
            or query.shape[2] != points.shape[2]:
        raise ValueError(f"knn: want query [B, S, D] and points [B, N, D], got "
                         f"{tuple(query.shape)} and {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"knn: k={k} outside 1..min(N={N}, {MAX_K})")


def check_kernel_args(query: torch.Tensor, points: torch.Tensor, k: int) -> None:
    """Raise on what the kernels do not take (``check_args``, then dtype,
    B, D)."""
    check_args(query, points, k)
    if query.dtype != torch.float32 or points.dtype != torch.float32:
        raise ValueError(f"knn: want float32, got {query.dtype}, {points.dtype}")
    B, _, D = query.shape
    if B > 65535:
        raise ValueError(f"knn: B={B} above the kernel's grid limit 65535")
    if D > MAX_D:
        raise ValueError(f"knn: D={D} above the kernel's limit {MAX_D}")


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """k nearest ``points`` of each query (see module doc)."""
    check_args(query, points, k)
    if query.device != points.device or query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn: unsupported devices {query.device}, {points.device}")
    return torch.ops.psg.knn(query.detach(), points.detach(), k)
