"""Exact bottom-k: CUDA kernel B and its plain PyTorch version.

Replaces ``pointsecguard_tpu/ops/pallas/bottomk.py:_bottomk_kernel``
(entry point ``bottom_k_pallas``). The kernel (``csrc/bottomk.cu``) is
bound by the one read of each row from device memory: a warp streams its
row with 128-bit loads, keeps the best so far in registers (one a lane)
and their k-th as a threshold, and inserts or merges the few elements
that pass the threshold (k ≤ 32; larger k sorts the row in shared memory).
Bounds: float32 rows, 1 ≤ k ≤ N ≤ 8192.

Contract (both versions): the k smallest values ascending and their
int32 indices, ties to the first occurrence — a stable sort cut to k,
which is ``lax.top_k`` of the negated row. ``bottom_k`` calls the custom
op ``psg::bottom_k`` (``library.py``): the dispatcher launches the kernel
for a CUDA tensor, which raises when the kernel cannot take it; only a
CPU tensor goes to ``bottom_k_plain``. The values carry the gradient of a
gather at the indices (the op's ``register_autograd``).
"""

from __future__ import annotations

import torch

MAX_N = 8192
launches = 0  # kernel launches by ``psg::bottom_k``; never the plain version or a trace


def bottom_k_plain(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort cut to k (``torch.topk`` does not order ties)."""
    v, i = torch.sort(vals, dim=-1, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


def check_kernel_args(vals: torch.Tensor, k: int) -> None:
    """Raise on what the kernel does not take (dtype, rank, N, k)."""
    if vals.dtype != torch.float32 or vals.dim() < 1:
        raise ValueError(f"bottom_k: want float32 [..., N], got {vals.dtype}")
    N = vals.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"bottom_k: N={N} outside the kernel's 1..{MAX_N} "
                         "(wider rows: bottomk_chunked.bottom_k_chunked)")
    if not 1 <= k <= N:
        raise ValueError(f"bottom_k: k={k} outside 1..N={N}")


def bottom_k(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis of [..., N] float32 (see module doc)."""
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bottom_k: unsupported device {vals.device}")
    return torch.ops.psg.bottom_k(vals, k)
