"""Exact bottom-k on wide rows: CUDA kernel 3 and its plain version.

Replaces ``pointsecguard_tpu/ops/pallas/bottomk.py:_chunked_kernel`` /
``_select_bottom_k`` (entry point ``bottom_k_pallas_chunked``). The kernel
(``csrc/bottomk_chunked.cu``) gives each row one warp: per-128-column
chunk minima, the k chunks with the smallest (minimum, chunk) pairs, then
k lexicographic passes over those chunks. It is bounded by reading each
value once from device memory. Bounds: float32 rows, 1 ≤ k ≤ 48,
k ≤ N ≤ 2²².

Contract (both versions): the k smallest values ascending and their int32
indices, ties to the first occurrence — a stable sort cut to k, as
``bottomk.bottom_k`` for narrow rows. ``bottom_k_chunked`` calls the
custom op ``psg::bottom_k_chunked`` (``library.py``): the dispatcher
launches the kernel for a CUDA tensor, which raises when the kernel cannot
take it; only a CPU tensor goes to ``bottomk.bottom_k_plain``.
"""

from __future__ import annotations

import torch

MAX_N = 1 << 22
MAX_K = 48
launches = 0  # kernel launches by ``psg::bottom_k_chunked``; never the plain version


def check_kernel_args(vals: torch.Tensor, k: int) -> None:
    """Raise on what the kernel does not take (dtype, rank, N, k)."""
    if vals.dtype != torch.float32 or vals.dim() < 1:
        raise ValueError(f"bottom_k_chunked: want float32 [..., N], got {vals.dtype}")
    N = vals.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"bottom_k_chunked: N={N} outside the kernel's 1..{MAX_N}")
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"bottom_k_chunked: k={k} outside 1..min(N={N}, {MAX_K})")


def bottom_k_chunked(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis of [..., N] float32 (see module doc)."""
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bottom_k_chunked: unsupported device {vals.device}")
    return torch.ops.psg.bottom_k_chunked(vals, k)
