"""Farthest point sampling and RandLA's random-sample pooling (port of
``pointsecguard_tpu/ops/sampling.py``)."""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.cuda.fps import fps
from pointsecguard_tpu_torch.ops.gather import gather_points
from pointsecguard_tpu_torch.utils.runtime import batch_draw


def farthest_point_sample(
    xyz: torch.Tensor,
    npoint: int,
    *,
    start_idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Iterative farthest point sampling (`pointnet_util.py:63-84`).

    Keeps the min squared distance of every point to the chosen set and
    repeatedly takes the argmax (first occurrence on ties). A CUDA tensor
    runs kernel A (``ops/cuda/fps.py``); a CPU tensor its plain loop.

    Args:
      xyz: [B, N, 3] point coordinates.
      npoint: number of points to select; npoint > N wraps onto index 0.
      start_idx: optional [B] initial indices. Default 0.
      generator: if given, the start index is drawn uniformly from it (the
        reference's ``torch.randint`` seeding) and ``start_idx`` is not
        read: the generator wins, as the key does in the JAX package. A
        rank of a data-parallel run keeps its rows of the global batch's
        draw (``utils.runtime.batch_draw``).

    Returns:
      [B, npoint] int32 indices of the selected points.
    """
    B, N, _ = xyz.shape
    if generator is not None:
        start = batch_draw(lambda shape: torch.randint(
            0, N, shape, generator=generator, device=generator.device,
            dtype=torch.int32), (B,)).to(xyz.device)
    elif start_idx is not None:
        start = start_idx.to(device=xyz.device, dtype=torch.int32)
    else:
        start = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    return fps(xyz.float(), npoint, start)


def random_sample_pool(feature: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """Max-pool features over precomputed pooling neighbourhoods
    (RandLA-Net's `random_sample`, `RandLANet.py:354-369`).

    Args:
      feature: [B, N, D].
      pool_idx: [B, N', K] indices into the N axis.

    Returns:
      [B, N', D] pooled features. ``amax``, not ``max(dim)``: pooling rows
      repeat neighbours (exact ties), and amax splits the gradient evenly
      over tied maxima, as ``jnp.max`` does.
    """
    return torch.amax(gather_points(feature, pool_idx), dim=2)
