"""PointNet semantic segmentation, classification and part segmentation
(port of ``pointsecguard_tpu/models/pointnet.py``).

The reference's `PointNet/models/pointnet.py` (STN3d `:10-45`, STNkd
`:48-85`, PointNetEncoder `:88-132`, regularizer `:135-141`) and its
`pointnet_sem_seg.py`, `pointnet_cls.py` and `pointnet_part_seg.py`
heads, channels-last: the per-point convs are ``PointConv`` (a Linear over
the trailing axis), the 3 × 3, 64 × 64 and 128 × 128 alignments batched
matrix products. PointNet builds no neighbourhood, so
its path launches none of the port's kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from pointsecguard_tpu_torch.models.common import BatchNorm, PointConv, dropout, linear


class STN(nn.Module):
    """Spatial / feature transform net: a k × k alignment matrix from
    [B, N, C] (STN3d with k = 3 over any channel count, and STNkd). Per
    point 64 → 128 → 1024, the max over N, then 512 → 256 with BatchNorm
    on [B, C] and k·k, plus the identity."""

    def __init__(self, k: int, in_features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.convs = nn.ModuleList([PointConv(in_features, 64, dtype=dtype),
                                    PointConv(64, 128, dtype=dtype),
                                    PointConv(128, 1024, dtype=dtype)])
        self.fc = nn.ModuleList([nn.Linear(1024, 512), nn.Linear(512, 256)])
        self.bns = nn.ModuleList([BatchNorm(512), BatchNorm(256)])
        self.out = nn.Linear(256, k * k)

    def forward(self, x: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x, momentum)
        h = torch.amax(x, dim=1)  # [B, 1024]
        for fc, bn in zip(self.fc, self.bns):
            h = torch.relu(bn(linear(h, fc, self.dtype), momentum))
        # the alignment matrix in float32 at least (small and sensitive)
        h = linear(h, self.out, self.dtype)
        h = h.to(torch.promote_types(h.dtype, torch.float32))
        iden = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + iden).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """The shared-MLP encoder (`pointnet.py:88-132` with
    ``feature_transform=True``): the STN3d matrix turns the xyz channels
    (the others pass through), the 64 × 64 STN the 64-wide features;
    returns ([B, N, 1024 + 64] per-point features, the STN3d matrix, the
    feature matrix), or with ``global_feat`` the [B, 1024] max in place of
    the per-point features (the classifier's)."""

    def __init__(self, in_features: int = 6, *, global_feat: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.global_feat = global_feat
        self.stn = STN(3, in_features, dtype)
        self.conv1 = PointConv(in_features, 64, dtype=dtype)
        self.fstn = STN(64, 64, dtype)
        self.conv2 = PointConv(64, 128, dtype=dtype)
        self.conv3 = PointConv(128, 1024, act="none", dtype=dtype)

    def forward(self, x: torch.Tensor, momentum: float = 0.9):
        trans = self.stn(x, momentum)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if x.shape[-1] > 3 else xyz
        x = self.conv1(x, momentum)
        trans_feat = self.fstn(x, momentum)
        point_feat = _bmm(x, trans_feat)
        x = self.conv3(self.conv2(point_feat, momentum), momentum)
        # amax: the max of a cloud of repeated points splits its gradient
        # over the ties, as jnp.max does
        global_feat = torch.amax(x, dim=1, keepdim=True)  # [B, 1, 1024]
        if self.global_feat:
            return global_feat[:, 0], trans, trans_feat
        tiled = global_feat.expand(-1, x.shape[1], -1)
        return torch.cat([tiled, point_feat], dim=-1), trans, trans_feat


class PointNetSemSeg(nn.Module):
    """PointNet semantic segmentation (`pointnet_sem_seg.py:9-38`).

    Reads the first 6 input channels (xyz | rgb) of [B, N, 9];
    1088 → 512 → 256 → 128 → ``num_classes``, no dropout. Returns
    (log-probabilities [B, N, num_classes], the 64 × 64 feature transform
    that ``feature_transform_regularizer`` reads)."""

    def __init__(self, num_classes: int = 13, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.feat = PointNetEncoder(6, dtype=dtype)
        self.convs = nn.ModuleList([PointConv(1088, 512, dtype=dtype),
                                    PointConv(512, 256, dtype=dtype),
                                    PointConv(256, 128, dtype=dtype)])
        self.cls = nn.Linear(128, num_classes)

    def forward(self, points: torch.Tensor, momentum: float = 0.9):
        x, _, trans_feat = self.feat(points[..., :6], momentum)
        for conv in self.convs:
            x = conv(x, momentum)
        logits = linear(x, self.cls, self.dtype).float()
        return torch.log_softmax(logits, dim=-1), trans_feat


class PointNetCls(nn.Module):
    """PointNet classifier (`pointnet_cls.py:6-29`): the encoder's global
    feature of the first 6 input channels (3 with ``normal_channel=False``),
    then Linear 512, BatchNorm, ReLU, Linear 256, dropout 0.4, BatchNorm,
    ReLU, Linear K, in the reference's order (the BatchNorm after the
    dropout). Returns (log-probabilities [B, K], the feature transform)."""

    def __init__(self, num_classes: int = 40, normal_channel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.in_features = 6 if normal_channel else 3
        self.dtype = dtype
        self.feat = PointNetEncoder(self.in_features, global_feat=True, dtype=dtype)
        self.fc = nn.ModuleList([nn.Linear(1024, 512), nn.Linear(512, 256)])
        self.bns = nn.ModuleList([BatchNorm(512), BatchNorm(256)])
        self.cls = nn.Linear(256, num_classes)

    def forward(self, points: torch.Tensor, momentum: float = 0.9, *,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """In training mode the dropout keeps ``dropout_mask`` [B, 256] or
        draws it from ``generator``."""
        x, _, trans_feat = self.feat(points[..., : self.in_features], momentum)
        x = torch.relu(self.bns[0](linear(x, self.fc[0], self.dtype), momentum))
        x = linear(x, self.fc[1], self.dtype)
        if self.training:
            x = dropout(x, 0.4, dropout_mask, generator)
        x = torch.relu(self.bns[1](x, momentum))
        return torch.log_softmax(linear(x, self.cls, self.dtype).float(), dim=-1), trans_feat


class PointNetPartSeg(nn.Module):
    """PointNet part segmentation (`pointnet_part_seg.py:9-85`): the STN3d
    matrix turns the xyz of the first 6 input channels (3 with
    ``normal_channel=False``), then five per-point stages 64, 128, 128
    (the 128 × 128 feature STN reads the third), 512 and 2048 (no
    activation); the max over the points with the 16-way one-hot, tiled,
    and every stage's output make a 4944-wide skip, then 256 → 256 → 128
    → ``part_num``. Returns (log-probabilities [B, N, part_num], the feature
    transform for ``feature_transform_regularizer``)."""

    def __init__(self, part_num: int = 50, normal_channel: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.in_features = 6 if normal_channel else 3
        self.dtype = dtype
        self.stn = STN(3, self.in_features, dtype)
        widths = (self.in_features, 64, 128, 128, 512, 2048)
        self.convs = nn.ModuleList(
            PointConv(a, b, act="relu" if b != 2048 else "none", dtype=dtype)
            for a, b in zip(widths[:-1], widths[1:]))
        self.fstn = STN(128, 128, dtype)
        self.head = nn.ModuleList([PointConv(2048 + 16 + sum(widths[1:]), 256, dtype=dtype),
                                   PointConv(256, 256, dtype=dtype),
                                   PointConv(256, 128, dtype=dtype)])
        self.cls = nn.Linear(128, part_num)

    def forward(self, points: torch.Tensor, cls_label: torch.Tensor, momentum: float = 0.9):
        x = points[..., : self.in_features]
        trans = self.stn(x, momentum)
        xyz = torch.bmm(x[..., :3], trans)
        x = torch.cat([xyz, x[..., 3:]], dim=-1) if x.shape[-1] > 3 else xyz
        outs = []
        for j, conv in enumerate(self.convs):
            if j == 3:  # the feature transform of the third stage's output
                trans_feat = self.fstn(outs[2], momentum)
                x = _bmm(outs[2], trans_feat)
            x = conv(x, momentum)
            outs.append(x)
        # amax: the max over a shape's repeated points splits its gradient
        # over the ties, as jnp.max does
        global_feat = torch.cat([torch.amax(outs[4], dim=1),
                                 cls_label.to(points.dtype)], dim=-1)
        expand = global_feat[:, None, :].expand(-1, points.shape[1], -1)
        h = torch.cat([expand, *outs], dim=-1)
        for conv in self.head:
            h = conv(h, momentum)
        return torch.log_softmax(linear(h, self.cls, self.dtype).float(), dim=-1), trans_feat


def _bmm(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """x @ trans in their promoted dtype, as ``jnp.einsum`` takes a bf16
    feature and the float32 alignment matrix."""
    dt = torch.promote_types(x.dtype, trans.dtype)
    return torch.bmm(x.to(dt), trans.to(dt))


def pointnet_aux_loss(out) -> torch.Tensor:
    """The segmentation net's extra training loss: 0.001 times the feature
    transform's regularizer (`pointnet_sem_seg.py:40-49`), from the
    forward's output (log-probabilities, feature transform)."""
    return 0.001 * feature_transform_regularizer(out[1])


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Orthogonality penalty: the mean over the batch of ‖A·(Aᵀ − I)‖_F
    (`pointnet.py:135-141`). The reference subtracts I before the product
    (A·(Aᵀ − I), not A·Aᵀ − I); the port keeps that on purpose, as the JAX
    package does, so that training matches the reference."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    prod = torch.bmm(trans, trans.transpose(1, 2) - eye)
    return torch.linalg.matrix_norm(prod).mean()
