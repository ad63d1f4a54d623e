"""Exact kNN fused with its distance: CUDA kernel 4 and its plain version.

Replaces ``pointsecguard_tpu/ops/pallas/knn.py:_knn_kernel`` (entry point
``knn_pallas``). The kernel (``csrc/knn.cu``) gives each query one thread,
streams the points through shared memory and keeps a sorted list of the
k best (value, index) pairs in registers; the [S, N] distance matrix
never reaches device memory. It is bounded by operations — the S·N
distance evaluations, and among them first by the shared-memory load
that brings each point to a warp. Its hot loop is arithmetic only (groups
of independent distance chains, one warp vote a group); candidates wait
in a per-thread queue and are inserted by all lanes of a warp together,
which leaves values, indices and tie order as point-by-point insertion
gives them. Bounds: float32, D ≥ 1, 1 ≤ k ≤ 48, k ≤ N, B ≤ 65535.

Contract (both versions): (sq_dists [B, S, k] float32, idx [B, S, k]
int32), nearest first, ties to the first occurrence — ``square_distance``
followed by a stable sort cut to k. The kernel rounds each distance as
``square_distance`` does: |q|² and |p|² with ``_sum_sq``'s own roundings
(small kernels of the same file compute them into the working space the
wrapper allocates), the cross term as the fused multiply-add chain a
float32 GEMM accumulates. ``knn`` launches the kernel for a CUDA tensor
and raises when the kernel cannot take it; only a CPU tensor goes to
``knn_plain``.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.distance import square_distance

MAX_K = 48
PLAIN_TILE = 4096  # query rows per distance block of the plain version
launches = 0  # kernel launches by ``knn``; never counts the plain version


def knn_plain(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``square_distance`` per block of ``PLAIN_TILE`` queries, then the
    stable sort cut to k (the [B, tile, N] block bounds the working set)."""
    vals, idx = [], []
    for s in range(0, query.shape[1], PLAIN_TILE):
        d = square_distance(query[:, s : s + PLAIN_TILE], points)
        v, i = torch.sort(d, dim=-1, stable=True)
        vals.append(v[..., :k])
        idx.append(i[..., :k].to(torch.int32))
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def _check(query: torch.Tensor, points: torch.Tensor, k: int) -> None:
    if query.dim() != 3 or points.dim() != 3 or query.shape[0] != points.shape[0] \
            or query.shape[2] != points.shape[2]:
        raise ValueError(f"knn: want query [B, S, D] and points [B, N, D], got "
                         f"{tuple(query.shape)} and {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"knn: k={k} outside 1..min(N={N}, {MAX_K})")


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """k nearest ``points`` of each query (see module doc)."""
    _check(query, points, k)
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_plain(query.float(), points.float(), k)
    if query.device.type != "cuda" or points.device != query.device:
        raise ValueError(f"knn: unsupported devices {query.device}, {points.device}")
    if query.dtype != torch.float32 or points.dtype != torch.float32:
        raise ValueError(f"knn: want float32, got {query.dtype}, {points.dtype}")
    B, S, D = query.shape
    N = points.shape[1]
    if B > 65535:
        raise ValueError(f"knn: B={B} above the kernel's grid limit 65535")
    from pointsecguard_tpu_torch.ops.cuda import build

    lib = build.load_library()
    build.require_sm90(query.device)
    # the pyramid's neighbour search passes one tensor twice: it is then
    # packed once
    points = points.contiguous()
    query = points if query is points else query.contiguous()
    out_v = torch.empty((B, S, k), dtype=torch.float32, device=query.device)
    out_i = torch.empty((B, S, k), dtype=torch.int32, device=query.device)
    # working space: queries and points packed as (x, y, z, |x|²) for
    # D = 3, |q|² and |p|² for any other D; small kernels of csrc/knn.cu
    # fill it, rounding as ``_sum_sq`` does
    scratch = torch.empty((B * S + B * N) * (4 if D == 3 else 1), dtype=torch.float32,
                          device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    code = lib.psg_knn(query.data_ptr(), points.data_ptr(), out_v.data_ptr(),
                       out_i.data_ptr(), scratch.data_ptr(), B, S, N, D, k, stream)
    build.check(code, "psg_knn")
    global launches
    launches += 1
    return out_v, out_i
