"""PointNet++ SSG and MSG classifiers and part-segmentation nets (port of
``pointsecguard_tpu/models/pointnet2_cls.py``).

The reference's `pointnet2_cls_ssg.py:6-39` and `pointnet2_cls_msg.py:6-40`
specs: two set-abstraction levels over the xyz (plus the normals as
features, unless ``normal_channel=False``), a group-all level of
256-512-1024, and the FC head 1024 → 512 → 256 → K with BatchNorm and
dropout. Input [B, N, 3 or 6]; output (log-probabilities [B, K], the
group-all features [B, 1, 1024]).

The geometry (FPS centres and ball-query groups of the two levels) comes
from ``build_geometry_cls`` / ``build_geometry_cls_msg``. Given to the
forward, it is held fixed, centres included (``--fixed_geometry``, and the
trainer's plan with random FPS starts). Without it, the forward builds the
indices from the coordinates it is given and gathers the centres from them
with their gradient, as the JAX forward does with ``geometry=None``: under
a coordinate attack the neighbourhoods move with the points, and the xyz
gradient keeps the term that flows through the centres.

The part-segmentation nets (`pointnet2_part_seg_ssg.py:7-52`,
`pointnet2_part_seg_msg.py:15-20`) add three feature-propagation hops back
to the input points, a skip of [category one-hot | xyz | input] and the
per-point head 128 → dropout 0.5 → 50. Their geometry
(``build_geometry_partseg*``) adds the two planned 3-NN hops (l1 ← l2,
l0 ← l1; l2 ← l3 broadcasts from the group-all point). Without a geometry
the forward builds it as the classifiers do and computes the 3-NN plans
from the moving centres and points, so that the interpolation weights
carry the xyz gradient too (``moving_geometry_partseg``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models.common import BatchNorm, PointMLP, dropout, linear
from pointsecguard_tpu_torch.models.pointnet2 import (
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMSG,
)

# per level: centres, radii, group sizes (`pointnet2_cls_ssg.py:14-16`,
# `pointnet2_cls_msg.py:11-13`); SSG has one radius a level
CLS_SSG_SPEC = ((512, (0.2,), (32,)), (128, (0.4,), (64,)))
CLS_SSG_MLPS = ((64, 64, 128), (128, 128, 256))
CLS_MSG_SPEC = ((512, (0.1, 0.2, 0.4), (16, 32, 128)),
                (128, (0.2, 0.4, 0.8), (32, 64, 128)))
CLS_MSG_MLPS = (((32, 32, 64), (64, 64, 128), (64, 96, 128)),
                ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
GROUP_ALL_MLP = (256, 512, 1024)
# the part-seg nets (`pointnet2_part_seg_ssg.py:14-16`, `pointnet2_part_seg_msg.py:15-20`):
# SSG's levels are the SSG classifier's; MSG takes larger groups
PARTSEG_SSG_SPEC = CLS_SSG_SPEC
PARTSEG_MSG_SPEC = ((512, (0.1, 0.2, 0.4), (32, 64, 128)), (128, (0.4, 0.8), (64, 128)))
PARTSEG_MSG_MLPS = (((32, 32, 64), (64, 64, 128), (64, 96, 128)),
                    ((128, 128, 256), (128, 196, 256)))
# the feature-propagation hops, l2 ← l3 first; MSG's last hop is (128, 128)
PARTSEG_SSG_FP_MLPS = ((256, 256), (256, 128), (128, 128, 128))
PARTSEG_MSG_FP_MLPS = ((256, 256), (256, 128), (128, 128))
NUM_PART_CLASSES, NUM_OBJECT_CLASSES = 50, 16


@torch.no_grad()
def _geometry(xyz: torch.Tensor, spec, generator, start_idx) -> dict:
    """Per level the FPS indices, the centres and one ball-query index set
    per radius; one FPS start per cloud and level from ``generator`` (or
    ``start_idx``), else index 0."""
    sa, fps_idx, cur = [], [], xyz
    for li, (npoint, radii, nsamples) in enumerate(spec):
        fps = ops.farthest_point_sample(
            cur, npoint, generator=generator,
            start_idx=None if start_idx is None else start_idx[li])
        centers = ops.gather_points(cur, fps)
        sa.append((centers, tuple(ops.ball_query(r, k, cur, centers)
                                  for r, k in zip(radii, nsamples))))
        fps_idx.append(fps)
        cur = centers
    return {"sa": tuple(sa), "fps": tuple(fps_idx)}


def build_geometry_cls(xyz: torch.Tensor, generator: torch.Generator | None = None,
                       start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The SSG classifier's plan: ``{"sa": ((centres, idx), (centres,
    idx)), "fps": (fps indices of both levels)}``, two FPS and two ball
    queries (k = 32 and 64). No gradient."""
    geo = _geometry(xyz, CLS_SSG_SPEC, generator, start_idx)
    return {"sa": tuple((c, idx[0]) for c, idx in geo["sa"]), "fps": geo["fps"]}


def build_geometry_cls_msg(xyz: torch.Tensor, generator: torch.Generator | None = None,
                           start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The MSG classifier's plan: per level the centres and three group
    index sets (k = 16, 32, 128, then 32, 64, 128), and the FPS indices."""
    return _geometry(xyz, CLS_MSG_SPEC, generator, start_idx)


def regather(geo: dict, xyz: torch.Tensor) -> dict:
    """``geo`` with its centres gathered again from ``xyz`` along its FPS
    indices, so that they carry ``xyz``'s gradient; the group indices stay
    constants (the selection's zero subgradient)."""
    sa, cur = [], xyz
    for (_, idx), fps in zip(geo["sa"], geo["fps"]):
        cur = ops.gather_points(cur, fps)
        sa.append((cur, idx))
    return {"sa": tuple(sa), "fps": geo["fps"]}


def moving_geometry(build, xyz: torch.Tensor) -> dict:
    """``build``'s plan of ``xyz`` (FPS from index 0), its centres carrying
    ``xyz``'s gradient (``regather``)."""
    return regather(build(xyz.detach()), xyz)


def with_three_nn(geo: dict, xyz: torch.Tensor) -> dict:
    """``geo`` (a two-level SA plan of ``xyz``) with the part-seg nets'
    two 3-NN plans, l1 ← l2 then l0 ← l1, computed from its centres and
    ``xyz``: where those carry a gradient, so do the weights."""
    l1, l2 = geo["sa"][0][0], geo["sa"][1][0]
    return {**geo, "fp": (ops.three_nn_plan(l1, l2), ops.three_nn_plan(xyz, l1))}


@torch.no_grad()
def build_geometry_partseg(xyz: torch.Tensor, generator: torch.Generator | None = None,
                           start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The SSG part-seg net's plan: the SSG classifier's two levels (two
    FPS, ball queries at k = 32 and 64) and the two 3-NN plans (idx,
    weight), two bottom-k calls at k = 3. No gradient: ``--fixed_geometry``
    and the trainer's plan."""
    return with_three_nn(build_geometry_cls(xyz, generator, start_idx), xyz)


@torch.no_grad()
def build_geometry_partseg_msg(xyz: torch.Tensor, generator: torch.Generator | None = None,
                               start_idx: Sequence[torch.Tensor] | None = None) -> dict:
    """The MSG part-seg net's plan: per level the centres and one group
    index set per radius (k = 32, 64, 128, then 64, 128), and the two 3-NN
    plans."""
    return with_three_nn(_geometry(xyz, PARTSEG_MSG_SPEC, generator, start_idx), xyz)


def moving_geometry_partseg(build_sa, xyz: torch.Tensor) -> dict:
    """The part-seg forward's own plan of ``xyz``: ``build_sa``'s indices
    (FPS from index 0, ball queries) as constants, the centres regathered
    with ``xyz``'s gradient, and the 3-NN plans computed from them, so that
    the interpolation weights carry the gradient through the dense and the
    sparse coordinates of both hops (JAX's ``geometry=None`` forward)."""
    return with_three_nn(moving_geometry(build_sa, xyz), xyz)


class ClsHead(nn.Module):
    """1024 → 512 → 256 → K: Linear, BatchNorm, ReLU and dropout (0.4,
    then ``drop2``) twice, then the log-softmax of the logits."""

    def __init__(self, num_classes: int, drop2: float = 0.4,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.ModuleList([nn.Linear(1024, 512), nn.Linear(512, 256)])
        self.bns = nn.ModuleList([BatchNorm(512), BatchNorm(256)])
        self.rates = (0.4, drop2)
        self.cls = nn.Linear(256, num_classes)

    def forward(self, x, momentum: float = 0.9, generator=None, dropout_masks=None):
        for j, (fc, bn, rate) in enumerate(zip(self.fc, self.bns, self.rates)):
            x = torch.relu(bn(linear(x, fc, self.dtype), momentum))
            if self.training:
                x = dropout(x, rate, None if dropout_masks is None else dropout_masks[j],
                            generator)
        return torch.log_softmax(linear(x, self.cls, self.dtype).float(), dim=-1)


class _PointNet2Cls(nn.Module):
    """Two planned set-abstraction levels, the group-all level and the
    head, which SSG and MSG share."""

    def __init__(self, levels: Sequence[nn.Module], width: int, num_classes: int,
                 drop2: float, normal_channel: bool, dtype: torch.dtype | None):
        super().__init__()
        self.normal_channel = normal_channel
        self.sa = nn.ModuleList([*levels, SetAbstraction(width, GROUP_ALL_MLP,
                                                         group_all=True, dtype=dtype)])
        self.head = ClsHead(num_classes, drop2, dtype)

    def forward(self, points: torch.Tensor, geometry: dict | None = None,
                momentum: float = 0.9, *, generator: torch.Generator | None = None,
                dropout_masks: Sequence[torch.Tensor] | None = None):
        """``geometry`` None: the plan of ``points`` with the centres
        carrying their gradient (``moving_geometry``). In training mode the
        head's two dropouts keep ``dropout_masks`` ([B, 512], [B, 256]) or
        draw them from ``generator``."""
        xyz = points[..., :3]
        feats = points[..., 3:] if self.normal_channel else None
        if geometry is None:
            geometry = moving_geometry(self.build_geometry, xyz)
        for sa, plan in zip(self.sa, (*geometry["sa"], None)):
            xyz, feats = sa(xyz, feats, plan, momentum)
        return self.head(feats[:, 0], momentum, generator, dropout_masks), feats


class PointNet2ClsSSG(_PointNet2Cls):
    """SSG classifier (`pointnet2_cls_ssg.py:6-39`): 512 centres, r 0.2,
    32 neighbours, 64-64-128; 128, 0.4, 64, 128-128-256; group-all; head
    dropout 0.4 and 0.4."""

    build_geometry = staticmethod(build_geometry_cls)

    def __init__(self, num_classes: int = 40, normal_channel: bool = True,
                 dtype: torch.dtype | None = None):
        width = 3 if normal_channel else 0
        levels = []
        for mlp in CLS_SSG_MLPS:
            levels.append(SetAbstraction(width, mlp, dtype=dtype))
            width = mlp[-1]
        super().__init__(levels, width, num_classes, 0.4, normal_channel, dtype)


class PointNet2ClsMSG(_PointNet2Cls):
    """MSG classifier (`pointnet2_cls_msg.py:6-40`): radii 0.1 / 0.2 / 0.4
    with 16 / 32 / 128 neighbours at 512 centres, 0.2 / 0.4 / 0.8 with
    32 / 64 / 128 at 128; group-all; head dropout 0.4 and 0.5."""

    build_geometry = staticmethod(build_geometry_cls_msg)

    def __init__(self, num_classes: int = 40, normal_channel: bool = True,
                 dtype: torch.dtype | None = None):
        width = 3 if normal_channel else 0
        levels = []
        for mlps in CLS_MSG_MLPS:
            levels.append(SetAbstractionMSG(width, mlps, dtype=dtype))
            width = sum(m[-1] for m in mlps)
        super().__init__(levels, width, num_classes, 0.5, normal_channel, dtype)


class _PointNet2PartSeg(nn.Module):
    """Two planned set-abstraction levels and the group-all level, three
    feature-propagation hops back to the input points, the per-point head
    128 → dropout 0.5 → ``num_classes``; SSG and MSG share it."""

    def __init__(self, levels: Sequence[nn.Module], widths: Sequence[int],
                 fp_mlps: Sequence[Sequence[int]], num_classes: int, in_channels: int,
                 dtype: torch.dtype | None):
        super().__init__()
        self.dtype = dtype
        self.sa = nn.ModuleList([*levels, SetAbstraction(widths[2], GROUP_ALL_MLP,
                                                         group_all=True, dtype=dtype)])
        # skip widths of the hops l2 ← l3, l1 ← l2, l0 ← l1; l0's is the
        # one-hot, the xyz and the whole input
        skips = (widths[2], widths[1], NUM_OBJECT_CLASSES + 3 + in_channels)
        fp, up = [], GROUP_ALL_MLP[-1]
        for skip, mlp in zip(skips, fp_mlps):
            fp.append(FeaturePropagation(skip + up, mlp, dtype=dtype))
            up = mlp[-1]
        self.fp = nn.ModuleList(fp)
        self.head = PointMLP(up, (128,), dtype=dtype)
        self.cls = nn.Linear(128, num_classes)

    def forward(self, points: torch.Tensor, cls_label: torch.Tensor,
                geometry: dict | None = None, momentum: float = 0.9, *,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """``points`` [B, N, 3 or 6], ``cls_label`` [B, 16] one-hot →
        (log-probabilities [B, N, num_classes], group-all features
        [B, 1, 1024]). The l0 features are the whole input, as in the
        reference's forward, normals or not. ``geometry`` None: the plan of
        ``points`` with the centres and 3-NN weights carrying their gradient
        (``moving_geometry_partseg``). In training mode the head's dropout
        keeps ``dropout_mask`` [B, N, 128] or draws it from ``generator``."""
        xyz = points[..., :3]
        if geometry is None:
            geometry = moving_geometry_partseg(self.build_sa, xyz)
        levels, feats = [xyz], [points]
        for sa, plan in zip(self.sa, (*geometry["sa"], None)):
            new_xyz, f = sa(levels[-1], feats[-1], plan, momentum)
            levels.append(new_xyz)
            feats.append(f)
        one_hot = cls_label[:, None, :].to(points.dtype).expand(-1, points.shape[1], -1)
        skips = (feats[2], feats[1], torch.cat([one_hot, xyz, points], dim=-1))
        up = feats[3]
        for fp, skip, plan in zip(self.fp, skips, (None, *geometry["fp"])):
            up = fp(skip, up, plan, momentum)
        x = self.head(up, momentum)
        if self.training:
            x = dropout(x, 0.5, dropout_mask, generator)
        return torch.log_softmax(linear(x, self.cls, self.dtype).float(), dim=-1), feats[3]


class PointNet2PartSegSSG(_PointNet2PartSeg):
    """SSG part segmentation (`pointnet2_part_seg_ssg.py:7-52`): 512
    centres, r 0.2, 32 neighbours, 64-64-128; 128, 0.4, 64, 128-128-256;
    group-all 256-512-1024; FP (256, 256), (256, 128), (128, 128, 128)."""

    build_geometry = staticmethod(build_geometry_partseg)
    build_sa = staticmethod(build_geometry_cls)

    def __init__(self, num_classes: int = NUM_PART_CLASSES, normal_channel: bool = False,
                 dtype: torch.dtype | None = None):
        c = 6 if normal_channel else 3
        widths, levels = [c], []
        for mlp in CLS_SSG_MLPS:
            levels.append(SetAbstraction(widths[-1], mlp, dtype=dtype))
            widths.append(mlp[-1])
        super().__init__(levels, widths, PARTSEG_SSG_FP_MLPS, num_classes, c, dtype)


class PointNet2PartSegMSG(_PointNet2PartSeg):
    """MSG part segmentation (`pointnet2_part_seg_msg.py:15-20`): radii
    0.1 / 0.2 / 0.4 with 32 / 64 / 128 neighbours at 512 centres, 0.4 /
    0.8 with 64 / 128 at 128; group-all; FP (256, 256), (256, 128),
    (128, 128)."""

    build_geometry = staticmethod(build_geometry_partseg_msg)
    build_sa = staticmethod(lambda xyz: _geometry(xyz, PARTSEG_MSG_SPEC, None, None))

    def __init__(self, num_classes: int = NUM_PART_CLASSES, normal_channel: bool = False,
                 dtype: torch.dtype | None = None):
        c = 6 if normal_channel else 3
        widths, levels = [c], []
        for mlps in PARTSEG_MSG_MLPS:
            levels.append(SetAbstractionMSG(widths[-1], mlps, dtype=dtype))
            widths.append(sum(m[-1] for m in mlps))
        super().__init__(levels, widths, PARTSEG_MSG_FP_MLPS, num_classes, c, dtype)
