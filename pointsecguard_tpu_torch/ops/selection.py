"""k-smallest selection (port of ``pointsecguard_tpu/ops/selection.py``).

Results are ascending with first-occurrence tie-breaking, identical to
``lax.top_k`` of the negated values. Routing follows the JAX package's
"pallas" strategy: for k ≤ 48, rows of N ≤ 8192 go to kernel B
(``ops/cuda/bottomk.py``) and wider rows to the wide-row kernel
(``ops/cuda/bottomk_chunked.py``, the port of ``bottom_k_pallas_chunked``);
each takes its plain version only for a CPU tensor. Larger k takes the
stable sort, as JAX sends it to ``lax.top_k``. The opt-in JAX strategies
(approx, twostage, iterative) are not ported.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda.bottomk import MAX_N as NARROW_MAX_N
from pointsecguard_tpu_torch.ops.cuda.bottomk import bottom_k, bottom_k_plain
from pointsecguard_tpu_torch.ops.cuda.bottomk_chunked import bottom_k_chunked

KERNEL_MAX_K = 48


def bottom_k_indices(
    vals: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and indices of the k smallest entries along the last axis.

    Args:
      vals: [..., N] values; selection runs in float32 (exact for the
        integer index values the ball query feeds it, N < 2^24).
      k: number of entries.

    Returns:
      (values [..., k] in ``vals.dtype``, indices [..., k] int32), ascending.
    """
    work = vals.float()
    if k > KERNEL_MAX_K:
        v, i = bottom_k_plain(work, k)
    elif work.shape[-1] > NARROW_MAX_N:
        v, i = bottom_k_chunked(work, k)
    else:
        v, i = bottom_k(work, k)
    return v.to(vals.dtype), i
