"""RandLA-Net for large-scale segmentation (port of
``pointsecguard_tpu/models/randlanet.py:27-379``).

The model contract is the reference's (`RandLANet.py:150-190`): a
5-level pyramid of (xyz, neighbour idx, pool idx, upsample idx) plus
[B, N, 6] features in, per-point logits out. ``build_pyramid`` builds the
pyramid on the device with the fused kNN kernel (``ops/cuda/knn.py``):
10 kNN calls per batch, a k=16 self-kNN and a 1-NN upsample index at each
level. Colour attacks never move xyz, so the attack CLI builds the
pyramid once per batch, and the position encodings of every
``LocalFeatureAggregation`` (xyz and parameters only) once more
(``collect_pos`` / ``pos_plan``); each attack iteration then skips the
neighbour-xyz gathers and both position convs.

``ap_impl="fused"`` (``--fused_ap``) runs the attentive poolings of
channel width below 128 (layers 0 and 1 at the S3DIS widths) through the
fused attentive-pooling kernels (``ops/cuda/attentive.py``), as the JAX
package runs them through its Pallas kernel; the default stays the
reference composition. The parameters are the same either way.

Training (``train.loops.train_randla``) runs the same module in train
mode: batch statistics at the fixed keep fraction 0.99 and the head's
dropout, whose mask a caller may draw from a generator or pass in;
``weighted_softmax_ce_loss`` is the reference's loss.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.data.randla import reduce_labels
from pointsecguard_tpu_torch.models.common import BatchNorm, PointConv, dropout, leaky_relu
from pointsecguard_tpu_torch.ops.attentive import fused_supported
from pointsecguard_tpu_torch.ops.cuda.attentive import attentive_pool_fused

# TF batch_normalization defaults in the reference (`RandLANet.py:160`,
# `helper_tf_util.py:457`): keep fraction 0.99, epsilon 1e-6.
BN_EPS = 1e-6
BN_MOM = 0.99
DROPOUT = 0.5  # on the head's 32 features, the JAX model's rate


def _conv(in_features: int, features: int, act: str = "leaky_relu") -> PointConv:
    # every conv of the RandLA graph ends in leaky_relu(0.2) except the
    # act-free mlp2 / shortcut (`helper_tf_util.py:169,249`)
    return PointConv(in_features, features, act=act, bn_epsilon=BN_EPS)


@torch.no_grad()
def build_pyramid(
    xyz: torch.Tensor,
    *,
    num_layers: int = 5,
    k: int = 16,
    sub_ratios: Sequence[int] = (4, 4, 4, 4, 2),
) -> dict:
    """The RandLA input pyramid (`main_S3DIS.py:188-214`): at each level
    the k-NN self-neighbours; the first N/r points (of an already shuffled
    cloud) become the next level; pool indices are the kNN rows of the
    kept points; upsample indices are the 1-NN of the level among the kept
    points. Exact at every level. The fused kNN kernel never writes the
    [S, N] distance matrix, so no level needs the query tiling of the
    JAX package's XLA route (``knn_tile``).

    Returns:
      dict with tuple-of-levels fields: xyz, neigh_idx, sub_idx, interp_idx.
    """
    xyzs, neighs, subs, interps = [], [], [], []
    cur = xyz
    for i in range(num_layers):
        n = cur.shape[1]
        # tiny clouds (tests, deep levels): repeat the neighbour list
        _, neigh = ops.knn(cur, cur, min(k, n))
        neigh = ops.repeat_pad_k(neigh, k)
        sub_n = n // sub_ratios[i]
        sub_xyz = cur[:, :sub_n, :]
        _, interp = ops.knn(cur, sub_xyz, 1)
        xyzs.append(cur)
        neighs.append(neigh)
        subs.append(neigh[:, :sub_n, :])  # kNN rows of the kept points
        interps.append(interp)
        cur = sub_xyz
    return {
        "xyz": tuple(xyzs),
        "neigh_idx": tuple(neighs),
        "sub_idx": tuple(subs),
        "interp_idx": tuple(interps),
    }


class AttentivePooling(nn.Module):
    """Attention-weighted neighbour aggregation (`RandLANet.py:397-410`):
    scores = Dense(feature_set) (no bias), softmax over the K axis in
    float32, weighted sum, then a conv.

    ``forward`` is the reference composition on feature_set [B, N, K, d];
    ``fused`` takes the k-major halves fn, fx [K, M, d/2] (fn first, as
    the feature set concatenates them) to the fused kernel, with the same
    Dense weight as its [d, d] projection in x·W layout.
    """

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.fc = nn.Linear(d_in, d_in, bias=False)
        self.mlp = _conv(d_in, d_out)

    def forward(self, feature_set: torch.Tensor, momentum: float = BN_MOM):
        # feature_set: [B, N, K, d]
        scores = torch.softmax(self.fc(feature_set).float(), dim=2)
        agg = torch.sum(feature_set * scores, dim=2)  # [B, N, d]
        return self.mlp(agg, momentum)

    def fused(self, fn: torch.Tensor, fx: torch.Tensor, momentum: float = BN_MOM):
        afn, afx = attentive_pool_fused(fn, fx, self.fc.weight.t())
        return self.mlp(torch.cat([afn, afx], dim=-1), momentum)  # [M, d_out]


class LocalFeatureAggregation(nn.Module):
    """The `building_block` of `RandLANet.py:332-344`: relative position
    encoding plus two rounds of attentive pooling over the kNN
    neighbourhood.

    ``pos``: the position plan of a ``collect_pos=True`` call (eval mode
    only: batch statistics would differ in train mode); the result is
    bit-identical either way. A reference layer's plan is (f_xyz1,
    f_xyz2); a fused layer's is the k-major (fx1 [K, M, d_in], fx2
    [K, M, d_out/2], kidx [B, K, N]) with M = B·N, kidx being the
    neighbour indices k-major within each cloud, so an attack iteration
    re-transposes no position encoding.
    """

    def __init__(self, d_in: int, d_out: int, ap_impl: str = "reference"):
        super().__init__()
        self.d_in, self.d_out, self.ap_impl = d_in, d_out, ap_impl
        self.mlp1 = _conv(10, d_in)
        self.att_pooling_1 = AttentivePooling(2 * d_in, d_out // 2)
        self.mlp2 = _conv(d_in, d_out // 2)
        self.att_pooling_2 = AttentivePooling(d_out, d_out)

    def fused(self, k: int) -> bool:
        """The JAX package's rule (`randlanet.py:221-230`): fused where
        both poolings are narrower than 128 channels."""
        return (self.ap_impl == "fused" and fused_supported(k, 2 * self.d_in)
                and fused_supported(k, self.d_out))

    def position_encoding(self, xyz, neigh_idx, momentum: float = BN_MOM):
        """(f_xyz1, f_xyz2) from xyz alone (`RandLANet.py:346-352`), or
        their k-major plan (fx1, fx2, kidx) in a fused layer."""
        neighbor_xyz = ops.gather_points(xyz, neigh_idx)  # [B, N, K, 3]
        center = xyz[:, :, None, :].expand_as(neighbor_xyz)
        rel = center - neighbor_xyz
        dist = torch.sqrt(torch.sum(rel**2, dim=-1, keepdim=True))
        f_xyz = torch.cat([dist, rel, center, neighbor_xyz], dim=-1)
        f_xyz1 = self.mlp1(f_xyz, momentum)
        f_xyz2 = self.mlp2(f_xyz1, momentum)
        B, N, K = neigh_idx.shape
        if not self.fused(K):
            return f_xyz1, f_xyz2

        def k_major(f):
            return f.permute(2, 0, 1, 3).reshape(K, B * N, f.shape[-1])

        kidx = neigh_idx.long().permute(0, 2, 1).contiguous()
        return k_major(f_xyz1), k_major(f_xyz2), kidx

    def forward(self, xyz, feature, neigh_idx, *, pos=None, collect_pos=False,
                momentum: float = BN_MOM):
        if pos is None:
            pos = self.position_encoding(xyz, neigh_idx, momentum)
        B, N, K = neigh_idx.shape
        if self.fused(K):
            fx1, fx2, kidx = pos
            fn = _k_major_rows(feature, kidx)
            f_agg = self.att_pooling_1.fused(fn, fx1, momentum)  # [M, d_out/2]
            fn2 = _k_major_rows(f_agg.reshape(B, N, -1), kidx)
            out = self.att_pooling_2.fused(fn2, fx2, momentum).reshape(B, N, -1)
        else:
            f_xyz1, f_xyz2 = pos
            f_neigh = ops.gather_points(feature, neigh_idx)  # [B, N, K, d_in]
            f_agg = self.att_pooling_1(torch.cat([f_neigh, f_xyz1], dim=-1), momentum)
            f_neigh2 = ops.gather_points(f_agg, neigh_idx)
            out = self.att_pooling_2(torch.cat([f_neigh2, f_xyz2], dim=-1), momentum)
        if collect_pos:
            return out, pos
        return out


def _k_major_rows(rows: torch.Tensor, kidx: torch.Tensor) -> torch.Tensor:
    """rows [B, N, d] gathered at kidx [B, K, N] → [K, B·N, d].

    The per-cloud gather of the reference composition, then one copy to
    k-major order. Gathering the flat [B·N, d] rows directly (B = 1 to
    ``torch.gather``, or ``index_select``) takes PyTorch's vectorized
    gather kernel, ~1 ms a call at these shapes on an H100 against
    ~35 us for this one (PERF.md)."""
    B, K, N = kidx.shape
    return ops.gather_points(rows, kidx).transpose(0, 1).reshape(K, B * N, rows.shape[-1])


class DilatedResBlock(nn.Module):
    """Dilated residual block (`RandLANet.py:323-330`)."""

    def __init__(self, d_in: int, d_out: int, ap_impl: str = "reference"):
        super().__init__()
        self.mlp1 = _conv(d_in, d_out // 2)
        self.lfa = LocalFeatureAggregation(d_out // 2, d_out, ap_impl)
        self.mlp2 = _conv(d_out, 2 * d_out, act="none")
        self.shortcut = _conv(d_in, 2 * d_out, act="none")

    def forward(self, feature, xyz, neigh_idx, *, pos=None, collect_pos=False,
                momentum: float = BN_MOM):
        f = self.mlp1(feature, momentum)
        f = self.lfa(xyz, f, neigh_idx, pos=pos, collect_pos=collect_pos,
                     momentum=momentum)
        if collect_pos:
            f, pos = f
        f = self.mlp2(f, momentum)
        out = leaky_relu(f + self.shortcut(feature, momentum))
        if collect_pos:
            return out, pos
        return out


class RandLANet(nn.Module):
    """RandLA-Net encoder/decoder (`RandLANet.py:150-190`).

    Call with features [B, N, d_in] and a pyramid from ``build_pyramid``;
    returns logits [B, N, num_classes] in float32 (no softmax, as the
    reference). ``collect_pos=True`` also returns the per-layer position
    encodings, which a later call takes as ``pos_plan``. ``momentum`` is
    BatchNorm's keep fraction in train mode (the reference's 0.99).
    ``ap_impl``: "reference" (the unfused composition) or "fused" (the
    fused attentive-pooling kernel where the JAX package fuses).
    """

    def __init__(self, num_classes: int = 13, d_out: Sequence[int] = (16, 64, 128, 256, 512),
                 d_in: int = 6, ap_impl: str = "reference"):
        super().__init__()
        if ap_impl not in ("reference", "fused"):
            raise ValueError(f"unknown ap_impl={ap_impl!r}: want 'reference' or 'fused'")
        self.fc0 = nn.Linear(d_in, 8)
        self.bn0 = BatchNorm(8, epsilon=BN_EPS)
        widths = [8] + [2 * d for d in d_out]  # block inputs / outputs
        self.blocks = nn.ModuleList(
            DilatedResBlock(widths[i], d_out[i], ap_impl) for i in range(len(d_out))
        )
        self.decoder_0 = _conv(widths[-1], widths[-1])
        # decoder j joins encoder output -j-2 with the upsampled features
        enc = [widths[1]] + widths[1:]  # channels of enc[0..num_layers]
        dec, up = [], widths[-1]
        for j in range(len(d_out)):
            skip = enc[-j - 2]
            dec.append(_conv(skip + up, skip))
            up = skip
        self.decoders = nn.ModuleList(dec)
        self.fc1 = _conv(up, 64)
        self.fc2 = _conv(64, 32)
        self.fc = nn.Linear(32, num_classes)

    def forward(self, features: torch.Tensor, pyramid: dict, *, pos_plan=None,
                collect_pos: bool = False, momentum: float = BN_MOM,
                generator: torch.Generator | None = None,
                dropout_mask: torch.Tensor | None = None):
        """In training mode the head's dropout (rate 0.5) keeps the
        entries where ``dropout_mask`` [B, N, 32] is true, or draws the
        mask from ``generator`` (on the model's device; torch's default
        generator without one). Evaluation mode applies none."""
        xyz, neigh_idx = pyramid["xyz"], pyramid["neigh_idx"]
        f = leaky_relu(self.bn0(self.fc0(features), momentum))
        enc, pos_out = [], []
        for i, block in enumerate(self.blocks):
            f_enc = block(f, xyz[i], neigh_idx[i],
                          pos=None if pos_plan is None else pos_plan[i],
                          collect_pos=collect_pos, momentum=momentum)
            if collect_pos:
                f_enc, p = f_enc
                pos_out.append(p)
            f = ops.random_sample_pool(f_enc, pyramid["sub_idx"][i])
            if i == 0:
                enc.append(f_enc)
            enc.append(f)
        f = self.decoder_0(f, momentum)
        for j, dec in enumerate(self.decoders):
            f_interp = ops.nearest_upsample(f, pyramid["interp_idx"][-j - 1])
            f = dec(torch.cat([enc[-j - 2], f_interp], dim=-1), momentum)
        f = self.fc2(self.fc1(f, momentum), momentum)
        if self.training:
            f = dropout(f, DROPOUT, dropout_mask, generator)
        logits = self.fc(f).float()
        if collect_pos:
            return logits, tuple(pos_out)
        return logits


def weighted_softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                             class_weights: torch.Tensor, *,
                             label_table: torch.Tensor | None = None) -> torch.Tensor:
    """RandLA's weighted softmax cross-entropy (`RandLANet.py:313-321`)
    with the ignored-label reduction of `RandLANet.py:103-124`: given
    ``label_table`` (a preset's ``label_table()`` on the labels' device,
    for SemanticKITTI's and Semantic3D's label 0; S3DIS has none), points
    whose raw label is ignored contribute nothing, and raw labels are
    reduced to the contiguous valid-class range. ``class_weights`` is
    indexed by the reduced label. Without a table the result is the mean
    over points of ``ce · w[y]``; with one, the masked mean, its
    denominator clamped at 1."""
    y = labels.reshape(-1).long()
    valid = None
    if label_table is not None:
        valid, y = reduce_labels(label_table, y)
    lp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    ce = -torch.gather(lp, 1, y[:, None])[:, 0]
    w = class_weights[y]
    if valid is None:
        return torch.mean(ce * w)
    v = valid.to(ce.dtype)
    return torch.sum(ce * w * v) / torch.clamp(torch.sum(v), min=1.0)
