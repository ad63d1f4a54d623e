"""Exact bottom-k on wide rows: CUDA kernel 3 and its plain version.

Replaces ``pointsecguard_tpu/ops/pallas/bottomk.py:225``
``bottom_k_pallas_chunked`` (``_chunked_kernel`` / ``_select_bottom_k``).
The kernel (``csrc/bottomk_chunked.cu``) gives each row one warp:
per-128-column chunk minima, the k chunks with the smallest (minimum,
chunk) pairs, whose largest minimum T is a threshold (every entry below
it lies in those chunks, and so do the first ties the result can need);
one pass over those chunks in column order keeps the entries below T and
the first k equal to it in a short list of ``list_capacity(k)`` pairs,
which a bitonic sort orders. A row whose list would outgrow that takes the
kernel's exact branch: the list is sorted, cut to k, and the k-th value
becomes the threshold (``overflow_rows_plain`` says which rows). It is
bounded by reading each value once from device memory. Bounds: float32
rows, 1 ≤ k ≤ 48, k ≤ N ≤ 2²².

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
CHUNK = 128  # the kernel's chunk width
launches = 0  # kernel launches by ``psg::bottom_k_chunked``; never the plain version


def list_capacity(k: int) -> int:
    """The kernel's short list at k: a power of two, ≥ 4k and ≥ k + 32."""
    return 64 if k <= 16 else 128 if k <= 32 else 256


def overflow_rows_plain(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Which rows of [..., N] take the kernel's exact branch: those whose
    entries below T, with the first k equal to T in the chosen chunks,
    outnumber ``list_capacity(k)`` (T: the k-th smallest (minimum, chunk)
    chunk minimum, +inf where there are fewer than k chunks). → [...] bool."""
    N = vals.shape[-1]
    rows = vals.reshape(-1, N)
    C = -(-N // CHUNK)
    padded = torch.nn.functional.pad(rows, (0, C * CHUNK - N), value=float("inf"))
    mins = padded.view(-1, C, CHUNK).amin(-1)
    k_sel = min(k, C)
    chosen = torch.sort(mins, dim=-1, stable=True).indices[:, :k_sel]
    if k_sel == k:
        T = mins.gather(-1, chosen[:, -1:])
    else:
        T = torch.full_like(mins[:, :1], float("inf"))
    in_chosen = torch.zeros_like(mins, dtype=torch.bool).scatter_(1, chosen, True)
    valid = (torch.arange(C * CHUNK, device=vals.device) < N).view(C, CHUNK)
    ties = ((padded.view(-1, C, CHUNK) == T[..., None]) & valid
            & in_chosen[..., None]).sum((1, 2))
    count = (rows < T).sum(-1) + ties.clamp(max=k)
    return (count > list_capacity(k)).view(vals.shape[:-1])


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


def overflow_rows(vals: torch.Tensor, k: int) -> int:
    """How many rows of [..., N] take the exact branch: on a CUDA tensor
    counted by the kernel itself in one more launch (counted as one; for
    checks, the model path never asks), on a CPU tensor by
    ``overflow_rows_plain``."""
    if vals.device.type == "cuda":
        from pointsecguard_tpu_torch.ops.cuda.library import bottom_k_chunked_overflows

        return bottom_k_chunked_overflows(vals, k)
    if vals.device.type != "cpu":
        raise ValueError(f"bottom_k_chunked: unsupported device {vals.device}")
    check_kernel_args(vals, k)
    return int(overflow_rows_plain(vals, k).sum())
