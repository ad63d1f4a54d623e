"""Sample-and-group for set abstraction (port of
``pointsecguard_tpu/ops/grouping.py``)."""

from __future__ import annotations

import torch

from pointsecguard_tpu_torch.ops.gather import gather_points
from pointsecguard_tpu_torch.ops.neighbors import ball_query
from pointsecguard_tpu_torch.ops.sampling import farthest_point_sample


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    feats: torch.Tensor | None,
    *,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS + ball query + relative grouping.

    Returns new_xyz [B, npoint, 3] and grouped [B, npoint, nsample, 3 (+D)],
    the leading 3 channels centre-relative."""
    fps_idx = farthest_point_sample(xyz, npoint, generator=generator)
    new_xyz = gather_points(xyz, fps_idx)
    idx = ball_query(radius, nsample, xyz, new_xyz)
    return new_xyz, group_relative(xyz, feats, idx, new_xyz)


def group_relative(
    xyz: torch.Tensor,
    feats: torch.Tensor | None,
    idx: torch.Tensor,
    centers: torch.Tensor,
    *,
    feats_first: bool = False,
) -> torch.Tensor:
    """[centre-relative xyz | feats] neighbourhood gather, as ONE gather
    (``feats_first=True`` → [feats | rel-xyz], the MSG channel order,
    `pointnet_util.py:255`).

    Equal to gathering xyz and feats apart and concatenating (subtracting
    0 from the feature half is exact), but the backward is one
    scatter-add over the shared indices instead of two."""
    if feats is None:
        return gather_points(xyz, idx) - centers[:, :, None, :]
    # by shape, not by slicing feats: npoint may exceed N (FPS wraps)
    zeros = feats.new_zeros((*centers.shape[:2], feats.shape[-1]))
    parts, offsets = [xyz, feats], [centers, zeros]
    if feats_first:
        parts, offsets = parts[::-1], offsets[::-1]
    both = gather_points(torch.cat(parts, dim=-1), idx)
    return both - torch.cat(offsets, dim=-1)[:, :, None, :]


def sample_and_group_all(
    xyz: torch.Tensor, feats: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One global group (`pointnet_util.py:146-163`): new_xyz zeros
    [B, 1, 3] and grouped [B, 1, N, 3 (+D)]. As in the reference, the
    coordinates are not centred."""
    new_xyz = xyz.new_zeros((xyz.shape[0], 1, xyz.shape[2]))
    grouped = xyz[:, None]
    if feats is not None:
        grouped = torch.cat([grouped, feats[:, None]], dim=-1)
    return new_xyz, grouped
