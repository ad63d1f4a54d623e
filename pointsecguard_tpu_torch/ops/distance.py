"""Pairwise squared distances (port of ``pointsecguard_tpu/ops/distance.py``).

The JAX package computes this outside any kernel (an XLA einsum at
Precision.HIGHEST), so here a library product is the counterpart:
``torch.bmm`` in full float32 (``utils.runtime`` turns TF32 off).
"""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance between every (src, dst) pair.

    Args:
      src: [B, N, C]
      dst: [B, M, C]

    Returns:
      [B, N, M] float32, associated as ``(|s|² − 2·s·dᵀ) + |d|²`` exactly
      as the JAX reference does, so radius tests and near-ties decide the
      same way. Float64 inputs take the cross term in float64, rounded
      once, as JAX's einsum with a float32 ``preferred_element_type`` does
      under ``jax.enable_x64``; the squared norms are float32 either way.
    """
    cross = torch.bmm(src, dst.transpose(1, 2)).float()
    same = src is dst  # a self-distance (the graphs' kNN): one norm serves both
    src_sq = _sum_sq(src.float())
    dst_sq = src_sq if same else _sum_sq(dst.float())
    return (src_sq[:, :, None] - 2.0 * cross) + dst_sq[:, None, :]


def _sum_sq_chain(x: torch.Tensor) -> torch.Tensor:
    """Σ_c x_c² over the last axis as a chain of fused multiply-adds,
    fma(x₂, x₂, fma(x₁, x₁, x₀·x₀)) — the rounding the JAX reference's
    ``sum(x**2)`` gets on the CPU, where XLA contracts it into FMAs; the
    BLAS product above rounds the same way. A float32 square is exact in
    float64, so one float64 multiply-add rounded to float32 is the fused op
    up to rare double-rounding ties. A 1-ulp difference here moves 3-NN
    weights of near-coincident points by ~1e-3, so the parity tests need
    the same rounding. The channels go to float64 once; a step is one
    ``addcmul`` and its rounding back to float32."""
    acc = x[..., 0] * x[..., 0]
    wide = x.double()
    for c in range(1, x.shape[-1]):
        xc = wide[..., c]
        acc = torch.addcmul(acc.double(), xc, xc).float()
    return acc


@torch.library.custom_op("psg_plain::sum_sq", mutates_args=())
def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """``_sum_sq_chain`` kept whole as one op: a trace (``torch.export``)
    then holds one node a norm, not three a channel (ResGCN's 24 graphs
    over 64 channels would be some 6,000 nodes). Both devices run the
    chain; the float32 gradient 2·g·x is bit for bit what autograd takes
    through the chain (each channel's product is exact in float64 and
    rounded once)."""
    return _sum_sq_chain(x)


@_sum_sq.register_fake
def _(x):
    return x.new_empty(x.shape[:-1])


def _sum_sq_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _sum_sq_backward(ctx, g):
    (x,) = ctx.saved_tensors
    return 2.0 * (g.unsqueeze(-1) * x)


_sum_sq.register_autograd(_sum_sq_backward, setup_context=_sum_sq_setup)
