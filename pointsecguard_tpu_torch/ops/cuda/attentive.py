"""Fused attentive pooling: CUDA kernel 5 (forward and backward) and its
plain version.

Replaces ``pointsecguard_tpu/ops/pallas/attentive.py:attentive_pool_fused``
(``_fwd_kernel``, ``_bwd_kernel`` and the custom VJP around them). The
kernels (``csrc/attentive.cu``) give each thread one row and four score
columns at every K (a [K, 4] register tile of the score product), stream
row tiles through two ``cp.async`` stages, keep the K scores in registers
and never write a score or a [K, M, 2D] tensor to memory; the backward
sums dW per block and then over blocks in a fixed order (no float
atomics), and only when ``w`` needs a gradient. Bounds: float32,
1 ≤ D ≤ 63, K ∈ {4, 16}.

``attentive_pool_fused`` checks its arguments and calls the custom op
``psg::attentive_fwd`` (``library.py``), whose ``register_autograd``
backward calls ``psg::attentive_bwd`` (with dW only when ``w`` needs a
gradient). For CUDA tensors the dispatcher launches the kernels, which
raise when they cannot take the input; only CPU tensors go to
``attentive_pool_fused_plain`` and its autograd gradient.
"""

from __future__ import annotations

import torch

MAX_D = 63
BUILT_K = (4, 16)  # the K instances csrc/attentive.cu compiles
fwd_launches = 0  # ``psg::attentive_fwd`` launches; never the plain version
bwd_launches = 0  # ``psg::attentive_bwd`` launches (with or without dW)


def _check(fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor) -> None:
    if fn.dim() != 3 or fx.shape != fn.shape or w.shape != (2 * fn.shape[2],) * 2:
        raise ValueError(f"attentive_pool_fused: want fn, fx [K, M, D] and w [2D, 2D], "
                         f"got {tuple(fn.shape)}, {tuple(fx.shape)}, {tuple(w.shape)}")


def check_kernel_args(fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernels do not take (shapes, dtype, K, D)."""
    _check(fn, fx, w)
    tensors = (fn, fx, w)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"attentive_pool_fused: want float32, got "
                         f"{[t.dtype for t in tensors]}")
    K, _, D = fn.shape
    if K not in BUILT_K or not 1 <= D <= MAX_D:
        raise ValueError(f"attentive_pool_fused: K={K}, D={D} outside the kernels' "
                         f"K in {BUILT_K}, 1 <= D <= {MAX_D}")


def attentive_pool_fused(
    fn: torch.Tensor, fx: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(agg_fn [M, D], agg_fx [M, D]) of fn, fx [K, M, D] under the
    [2D, 2D] score projection w (see ``attentive_pool_fused_plain``)."""
    _check(fn, fx, w)
    tensors = (fn, fx, w)
    if fn.device.type not in ("cpu", "cuda") or any(t.device != fn.device for t in tensors):
        raise ValueError(f"attentive_pool_fused: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    return torch.ops.psg.attentive_fwd(fn, fx, w)
