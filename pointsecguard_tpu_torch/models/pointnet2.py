"""PointNet++ SSG semantic segmentation (port of
``pointsecguard_tpu/models/pointnet2.py:29-251``).

Channel specs and grouping semantics are the reference's
(`pointnet2_sem_seg.py:6-40` over `pointnet_util.py`). The xyz-only
geometry (FPS centres, ball-query groups, 3-NN plans) is built by
``build_geometry``; colour attacks never move xyz, so the attack CLI
builds it once per batch and each attack iteration is gathers and
matmuls only. FPS starts at index 0, as in the JAX attack path; the
trainer passes a generator and every level draws one random start per
cloud, as the JAX model does under its ``sample`` rng.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models.common import PointMLP

# SSG architecture spec (`pointnet2_sem_seg.py:9-16`)
SSG_NPOINTS = (1024, 256, 64, 16)
SSG_RADII = (0.1, 0.2, 0.4, 0.8)
SSG_NSAMPLES = (32, 32, 32, 32)
SSG_SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
# feature propagation, in the order applied: fp4 (l3←l4) … fp1 (l0←l1)
SSG_FP_MLPS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))
DROPOUT = 0.5  # on the head's 128 features (`pointnet2_sem_seg.py:27`)


def sa_plan(cur: torch.Tensor, npoint: int, radius: float, nsample: int, *,
            generator: torch.Generator | None = None,
            start_idx: torch.Tensor | None = None):
    """One SA level's geometry: FPS centres + ball-query group indices."""
    fps = ops.farthest_point_sample(cur, npoint, start_idx=start_idx,
                                    generator=generator)
    centers = ops.gather_points(cur, fps)
    return centers, ops.ball_query(radius, nsample, cur, centers)


def three_nn_plan(dst: torch.Tensor, src: torch.Tensor):
    """3-NN interpolation plan (idx [B,N,3], weight [B,N,3]) for one
    FeaturePropagation hop."""
    return ops.three_nn_plan(dst, src)


@torch.no_grad()
def build_geometry(xyz: torch.Tensor, generator: torch.Generator | None = None,
                   start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The SSG geometry plan from coordinates alone: per SA level
    (centres, group idx), per FP hop (3-NN idx, weight), l0←l1 first.

    FPS starts at index 0 (the attack and eval paths). The training-mode
    geometry passes ``generator``: each SA level then draws one start per
    cloud from it (`pointnet_util.py:74`), four draws of [B] a batch.
    ``start_idx`` (one [B] tensor per level) fixes the starts instead; the
    generator wins where both are given. The geometry carries no gradient:
    indices, and 3-NN weights that depend on xyz alone."""
    sa_plans = []
    cur = xyz
    for li, (npoint, radius, nsample) in enumerate(
            zip(SSG_NPOINTS, SSG_RADII, SSG_NSAMPLES)):
        plan = sa_plan(cur, npoint, radius, nsample, generator=generator,
                       start_idx=None if start_idx is None else start_idx[li])
        sa_plans.append(plan)
        cur = plan[0]
    levels = [xyz] + [p[0] for p in sa_plans]  # l0..l4 coordinates
    fp_plans = [
        three_nn_plan(levels[li], levels[li + 1]) for li in range(len(levels) - 1)
    ]
    return {"sa": tuple(sa_plans), "fp": tuple(fp_plans)}


class SetAbstraction(nn.Module):
    """SSG set abstraction (`pointnet_util.py:166-207`) over a planned
    geometry: grouped [rel-xyz | feats], shared MLP, max over the group."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointMLP(3 + in_features, mlp)

    def forward(self, xyz, feats, plan, momentum: float = 0.9):
        new_xyz, idx = plan
        grouped = ops.group_relative(xyz, feats, idx, new_xyz)
        x = self.mlp(grouped, momentum)
        # amax, not max(dim): the groups are full of exact duplicates and
        # amax splits the gradient evenly over tied maxima, as JAX does
        return new_xyz, torch.amax(x, dim=2)


class FeaturePropagation(nn.Module):
    """Feature propagation (`pointnet_util.py:270-320`) over a planned
    3-NN interpolation."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointMLP(in_features, mlp)

    def forward(self, feats1, feats2, plan, momentum: float = 0.9):
        interpolated = ops.apply_three_nn(feats2, *plan)
        x = interpolated if feats1 is None else torch.cat(
            [feats1, interpolated], dim=-1
        )
        return self.mlp(x, momentum)


class PointNet2SemSegSSG(nn.Module):
    """PointNet++ SSG semantic segmentation (`pointnet2_sem_seg.py:6-40`).

    Input [B, N, 9] (centred xy, z | rgb | normalised xyz); output
    (log-probabilities [B, N, num_classes], l4 features) — the model
    applies log_softmax itself, like the reference. ``geometry`` (from
    ``build_geometry``) skips all neighbour search; without it the
    forward builds it.
    """

    def __init__(self, num_classes: int = 13, in_features: int = 9):
        super().__init__()
        widths = [in_features] + [m[-1] for m in SSG_SA_MLPS]  # l0..l4
        self.sa = nn.ModuleList(
            SetAbstraction(widths[i], SSG_SA_MLPS[i]) for i in range(4)
        )
        fp = []
        up = widths[4]
        for j, mlp in enumerate(SSG_FP_MLPS):  # l3←l4, l2←l3, l1←l2, l0←l1
            skip = widths[3 - j] if j < 3 else 0  # l0 passes no features
            fp.append(FeaturePropagation(skip + up, mlp))
            up = mlp[-1]
        self.fp = nn.ModuleList(fp)
        self.head = PointMLP(up, (128,))
        self.cls = nn.Linear(128, num_classes)

    def forward(self, points: torch.Tensor, geometry: dict | None = None,
                momentum: float = 0.9, *,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """In training mode the head's dropout (rate 0.5) keeps the
        entries where ``dropout_mask`` [B, N, 128] is true, or draws the
        mask from ``generator`` (on the model's device; torch's default
        generator without one). Evaluation mode applies none."""
        xyz = [points[..., :3]]
        feats = [points]  # all 9 channels, as in the reference forward
        if geometry is None:
            geometry = build_geometry(xyz[0])
        for sa, plan in zip(self.sa, geometry["sa"]):
            new_xyz, f = sa(xyz[-1], feats[-1], plan, momentum)
            xyz.append(new_xyz)
            feats.append(f)
        up = feats[4]
        for j, fp in enumerate(self.fp):
            li = 3 - j  # dense level of this hop
            skip = feats[li] if li > 0 else None
            up = fp(skip, up, geometry["fp"][li], momentum)
        x = self.head(up, momentum)
        if self.training:
            if dropout_mask is None:
                dropout_mask = torch.rand(
                    x.shape, generator=generator, device=x.device) >= DROPOUT
            x = torch.where(dropout_mask, x / (1.0 - DROPOUT), torch.zeros_like(x))
        logits = self.cls(x).float()
        return torch.log_softmax(logits, dim=-1), feats[4]


def weighted_nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
                      class_weights: torch.Tensor) -> torch.Tensor:
    """Weighted NLL with ``F.nll_loss(weight=...)`` semantics
    (`pointnet2_sem_seg.py:43-49`, `train_semseg.py:177`): the sum over
    points of w[y]·(−logp[y]) over Σ w[y]."""
    lp = log_probs.reshape(-1, log_probs.shape[-1])
    y = labels.reshape(-1)
    picked = torch.gather(lp, 1, y[:, None])[:, 0]
    w = class_weights[y]
    return -(w * picked).sum() / w.sum()
