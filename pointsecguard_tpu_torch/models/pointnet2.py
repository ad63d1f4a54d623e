"""PointNet++ SSG and MSG semantic segmentation (port of
``pointsecguard_tpu/models/pointnet2.py``).

Channel specs and grouping semantics are the reference's
(`pointnet2_sem_seg.py:6-40`, `pointnet2_sem_seg_msg.py:6-41` over
`pointnet_util.py`). The xyz-only geometry (FPS centres, ball-query
groups, 3-NN plans) is built by ``build_geometry`` (``build_geometry_msg``:
one ball query per radius); colour attacks never move xyz, so the attack CLI
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
from pointsecguard_tpu_torch.models.common import PointMLP, dropout

# SSG architecture spec (`pointnet2_sem_seg.py:9-16`)
SSG_NPOINTS = (1024, 256, 64, 16)
SSG_RADII = (0.1, 0.2, 0.4, 0.8)
SSG_NSAMPLES = (32, 32, 32, 32)
SSG_SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
# MSG architecture spec (`pointnet2_sem_seg_msg.py:9-16`): per level the
# centres, and one radius, group size and MLP per scale
MSG_SPEC = (
    (1024, (0.05, 0.1), (16, 32)),
    (256, (0.1, 0.2), (16, 32)),
    (64, (0.2, 0.4), (16, 32)),
    (16, (0.4, 0.8), (16, 32)),
)
MSG_SA_MLPS = (
    ((16, 16, 32), (32, 32, 64)),
    ((64, 64, 128), (64, 96, 128)),
    ((128, 196, 256), (128, 196, 256)),
    ((256, 256, 512), (256, 384, 512)),
)
# feature propagation, in the order applied: fp4 (l3←l4) … fp1 (l0←l1);
# the same for SSG and MSG
SSG_FP_MLPS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))
DROPOUT = 0.5  # on the head's 128 features (`pointnet2_sem_seg.py:27`)


def sa_plan_msg(cur: torch.Tensor, npoint: int, radii: Sequence[float],
                nsamples: Sequence[int], *, generator: torch.Generator | None = None,
                start_idx: torch.Tensor | None = None):
    """One SA level's geometry: FPS centres + one ball-query group index
    set per radius."""
    fps = ops.farthest_point_sample(cur, npoint, start_idx=start_idx,
                                    generator=generator)
    centers = ops.gather_points(cur, fps)
    return centers, tuple(ops.ball_query(r, k, cur, centers)
                          for r, k in zip(radii, nsamples))


def sa_plan(cur: torch.Tensor, npoint: int, radius: float, nsample: int, *,
            generator: torch.Generator | None = None,
            start_idx: torch.Tensor | None = None):
    """One SSG level's geometry: FPS centres + ball-query group indices."""
    centers, (idx,) = sa_plan_msg(cur, npoint, (radius,), (nsample,),
                                  generator=generator, start_idx=start_idx)
    return centers, idx


def three_nn_plan(dst: torch.Tensor, src: torch.Tensor):
    """3-NN interpolation plan (idx [B,N,3], weight [B,N,3]) for one
    FeaturePropagation hop."""
    return ops.three_nn_plan(dst, src)


def _geometry(xyz, spec, level_plan, generator, start_idx) -> dict:
    sa_plans = []
    cur = xyz
    for li, level in enumerate(spec):
        plan = level_plan(cur, *level, generator=generator,
                          start_idx=None if start_idx is None else start_idx[li])
        sa_plans.append(plan)
        cur = plan[0]
    levels = [xyz] + [p[0] for p in sa_plans]  # l0..l4 coordinates
    fp_plans = [
        three_nn_plan(levels[li], levels[li + 1]) for li in range(len(levels) - 1)
    ]
    return {"sa": tuple(sa_plans), "fp": tuple(fp_plans)}


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
    return _geometry(xyz, zip(SSG_NPOINTS, SSG_RADII, SSG_NSAMPLES), sa_plan,
                     generator, start_idx)


@torch.no_grad()
def build_geometry_msg(xyz: torch.Tensor, generator: torch.Generator | None = None,
                       start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The MSG geometry plan (see ``build_geometry``): per level the FPS
    centres and one ball-query index set per radius, so a batch is 4 FPS
    and 8 ball queries; the same draws of ``generator`` as SSG's."""
    return _geometry(xyz, MSG_SPEC, sa_plan_msg, generator, start_idx)


class SetAbstraction(nn.Module):
    """SSG set abstraction (`pointnet_util.py:166-207`) over a planned
    geometry: grouped [rel-xyz | feats], shared MLP, max over the group.
    ``group_all`` is the classifiers' last level: one group of every
    point, [xyz | feats] not centred (``ops.sample_and_group_all``), and
    no plan."""

    def __init__(self, in_features: int, mlp: Sequence[int], *, group_all: bool = False):
        super().__init__()
        self.group_all = group_all
        self.mlp = PointMLP(3 + in_features, mlp)

    def forward(self, xyz, feats, plan, momentum: float = 0.9):
        if self.group_all:
            new_xyz, grouped = ops.sample_and_group_all(xyz, feats)
        else:
            new_xyz, idx = plan
            grouped = ops.group_relative(xyz, feats, idx, new_xyz)
        x = self.mlp(grouped, momentum)
        # amax, not max(dim): the groups are full of exact duplicates and
        # amax splits the gradient evenly over tied maxima, as JAX does
        return new_xyz, torch.amax(x, dim=2)


class SetAbstractionMSG(nn.Module):
    """Multi-scale-grouping set abstraction (`pointnet_util.py:210-267`)
    over a planned geometry: per radius grouped [feats | rel-xyz], its own
    shared MLP and the max over the group; the scales concatenated."""

    def __init__(self, in_features: int, mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.mlps = nn.ModuleList(PointMLP(in_features + 3, mlp) for mlp in mlps)

    def forward(self, xyz, feats, plan, momentum: float = 0.9):
        new_xyz, idx_list = plan
        outs = [
            torch.amax(mlp(ops.group_relative(xyz, feats, idx, new_xyz, feats_first=True),
                           momentum), dim=2)
            for mlp, idx in zip(self.mlps, idx_list)
        ]
        return new_xyz, torch.cat(outs, dim=-1)


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


class _PointNet2SemSeg(nn.Module):
    """The four SA levels ``sa`` (feature widths l0..l4 in ``widths``), then
    the FP stack, the head and the classifier that SSG and MSG share."""

    def __init__(self, sa: Sequence[nn.Module], widths: Sequence[int], num_classes: int):
        super().__init__()
        self.sa = nn.ModuleList(sa)
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
            geometry = self.build_geometry(xyz[0])
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
            x = dropout(x, DROPOUT, dropout_mask, generator)
        logits = self.cls(x).float()
        return torch.log_softmax(logits, dim=-1), feats[4]


class PointNet2SemSegSSG(_PointNet2SemSeg):
    """PointNet++ SSG semantic segmentation (`pointnet2_sem_seg.py:6-40`).

    Input [B, N, 9] (centred xy, z | rgb | normalised xyz); output
    (log-probabilities [B, N, num_classes], l4 features) — the model
    applies log_softmax itself, like the reference. ``geometry`` (from
    ``build_geometry``) skips all neighbour search; without it the
    forward builds it.
    """

    build_geometry = staticmethod(build_geometry)

    def __init__(self, num_classes: int = 13, in_features: int = 9):
        widths = [in_features] + [m[-1] for m in SSG_SA_MLPS]  # l0..l4
        super().__init__([SetAbstraction(widths[i], SSG_SA_MLPS[i]) for i in range(4)],
                         widths, num_classes)


class PointNet2SemSegMSG(_PointNet2SemSeg):
    """PointNet++ MSG semantic segmentation (`pointnet2_sem_seg_msg.py:6-41`):
    SSG's input, output, FP stack and head over multi-scale SA levels;
    ``geometry`` comes from ``build_geometry_msg``."""

    build_geometry = staticmethod(build_geometry_msg)

    def __init__(self, num_classes: int = 13, in_features: int = 9):
        widths = [in_features]  # l0..l4: the scales' widths summed
        for mlps in MSG_SA_MLPS:
            widths.append(sum(m[-1] for m in mlps))
        super().__init__([SetAbstractionMSG(widths[i], MSG_SA_MLPS[i]) for i in range(4)],
                         widths, num_classes)


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
