"""k-smallest selection (port of ``pointsecguard_tpu/ops/selection.py``).

Results are ascending with first-occurrence tie-breaking, identical to
``lax.top_k`` of the negated values. Routing follows the JAX package's
by k: k ≤ 48 goes to kernel B (``ops/cuda/bottomk.py``, which takes its
plain version only for a CPU tensor); larger k takes the stable sort, as
JAX sends it to ``lax.top_k``. The opt-in JAX strategies (approx,
twostage, iterative) are not ported.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda.bottomk import bottom_k, bottom_k_plain

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
    if k <= KERNEL_MAX_K:
        v, i = bottom_k(work, k)
    else:
        v, i = bottom_k_plain(work, k)
    return v.to(vals.dtype), i
