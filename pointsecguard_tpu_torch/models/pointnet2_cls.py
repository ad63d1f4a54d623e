"""PointNet++ SSG and MSG classifiers (port of
``pointsecguard_tpu/models/pointnet2_cls.py:30-104,209-221``).

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
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models.common import BatchNorm, dropout
from pointsecguard_tpu_torch.models.pointnet2 import SetAbstraction, SetAbstractionMSG

# per level: centres, radii, group sizes (`pointnet2_cls_ssg.py:14-16`,
# `pointnet2_cls_msg.py:11-13`); SSG has one radius a level
CLS_SSG_SPEC = ((512, (0.2,), (32,)), (128, (0.4,), (64,)))
CLS_SSG_MLPS = ((64, 64, 128), (128, 128, 256))
CLS_MSG_SPEC = ((512, (0.1, 0.2, 0.4), (16, 32, 128)),
                (128, (0.2, 0.4, 0.8), (32, 64, 128)))
CLS_MSG_MLPS = (((32, 32, 64), (64, 64, 128), (64, 96, 128)),
                ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
GROUP_ALL_MLP = (256, 512, 1024)


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


class ClsHead(nn.Module):
    """1024 → 512 → 256 → K: Linear, BatchNorm, ReLU and dropout (0.4,
    then ``drop2``) twice, then the log-softmax of the logits."""

    def __init__(self, num_classes: int, drop2: float = 0.4):
        super().__init__()
        self.fc = nn.ModuleList([nn.Linear(1024, 512), nn.Linear(512, 256)])
        self.bns = nn.ModuleList([BatchNorm(512), BatchNorm(256)])
        self.rates = (0.4, drop2)
        self.cls = nn.Linear(256, num_classes)

    def forward(self, x, momentum: float = 0.9, generator=None, dropout_masks=None):
        for j, (fc, bn, rate) in enumerate(zip(self.fc, self.bns, self.rates)):
            x = torch.relu(bn(fc(x), momentum))
            if self.training:
                x = dropout(x, rate, None if dropout_masks is None else dropout_masks[j],
                            generator)
        return torch.log_softmax(self.cls(x).float(), dim=-1)


class _PointNet2Cls(nn.Module):
    """Two planned set-abstraction levels, the group-all level and the
    head, which SSG and MSG share."""

    def __init__(self, levels: Sequence[nn.Module], width: int, num_classes: int,
                 drop2: float, normal_channel: bool):
        super().__init__()
        self.normal_channel = normal_channel
        self.sa = nn.ModuleList([*levels, SetAbstraction(width, GROUP_ALL_MLP,
                                                         group_all=True)])
        self.head = ClsHead(num_classes, drop2)

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

    def __init__(self, num_classes: int = 40, normal_channel: bool = True):
        width = 3 if normal_channel else 0
        levels = []
        for mlp in CLS_SSG_MLPS:
            levels.append(SetAbstraction(width, mlp))
            width = mlp[-1]
        super().__init__(levels, width, num_classes, 0.4, normal_channel)


class PointNet2ClsMSG(_PointNet2Cls):
    """MSG classifier (`pointnet2_cls_msg.py:6-40`): radii 0.1 / 0.2 / 0.4
    with 16 / 32 / 128 neighbours at 512 centres, 0.2 / 0.4 / 0.8 with
    32 / 64 / 128 at 128; group-all; head dropout 0.4 and 0.5."""

    build_geometry = staticmethod(build_geometry_cls_msg)

    def __init__(self, num_classes: int = 40, normal_channel: bool = True):
        width = 3 if normal_channel else 0
        levels = []
        for mlps in CLS_MSG_MLPS:
            levels.append(SetAbstractionMSG(width, mlps))
            width = sum(m[-1] for m in mlps)
        super().__init__(levels, width, num_classes, 0.5, normal_channel)
