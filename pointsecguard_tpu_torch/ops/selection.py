"""k-smallest selection (port of ``pointsecguard_tpu/ops/selection.py``).

Results are ascending with first-occurrence tie-breaking, identical to
``lax.top_k`` of the negated values. Routing follows the JAX package's
"pallas" strategy: for k ≤ 48, rows of N ≤ 8192 go to kernel B
(``ops/cuda/bottomk.py``) and wider rows to the wide-row kernel
(``ops/cuda/bottomk_chunked.py``, the port of ``bottom_k_pallas_chunked``);
each takes its plain version only for a CPU tensor. Larger k takes the
stable sort, as JAX sends it to ``lax.top_k``. JAX's opt-in strategies
are exact selections (twostage, iterative) or, on the CPU, exact in fact
(approx): ``ops.knn`` takes their names onto these routes.

The values carry a gradient on every route, the JAX package's
``_pallas_bottom_k_diff`` (`selection.py:75-124`): the two kernels' custom
ops scatter the values' cotangent into a zero row at the returned indices
(``ops/cuda/library.py``), and the stable sort carries the same gradient
itself. 3-NN interpolation weights differentiate through those values
under coordinate attacks.
"""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda.bottomk import MAX_N as NARROW_MAX_N
from pointsecguard_tpu_torch.ops.cuda.bottomk import bottom_k, bottom_k_plain
from pointsecguard_tpu_torch.ops.cuda.bottomk_chunked import bottom_k_chunked

KERNEL_MAX_K = 48


def _select(work: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    if k > KERNEL_MAX_K:
        return bottom_k_plain(work, k)
    if work.shape[-1] > NARROW_MAX_N:
        return bottom_k_chunked(work, k)
    return bottom_k(work, k)


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
    v, i = _select(vals.float(), k)
    return v.to(vals.dtype), i
