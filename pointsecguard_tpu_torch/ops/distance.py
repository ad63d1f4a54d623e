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
    src = src.float()
    dst = dst.float()
    return (_sum_sq(src)[:, :, None] - 2.0 * cross) + _sum_sq(dst)[:, None, :]


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Σ_c x_c² over the last axis as a chain of fused multiply-adds,
    fma(x₂, x₂, fma(x₁, x₁, x₀·x₀)) — the rounding the JAX reference's
    ``sum(x**2)`` gets on the CPU, where XLA contracts it into FMAs; the
    BLAS product above rounds the same way. A float32 square is exact in
    float64, so one float64 add rounded to float32 is the fused op up to
    rare double-rounding ties. A 1-ulp difference here moves 3-NN weights
    of near-coincident points by ~1e-3, so the parity tests need the same
    rounding."""
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        xc = x[..., c].double()
        acc = (xc * xc + acc.double()).float()
    return acc
